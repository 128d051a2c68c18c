"""The 95th percentile over every block of the window of the time from
the block's due time (its last sample's arrival on the wire schedule) to
its outputs on the host, ms.  An open loop's metric."""

from sdrbench import yardstick


def read(run):
    if run.loop != "open":
        return None
    return yardstick.percentile(yardstick.latencies_ms(
        [b.due for b in run.blocks], [b.done for b in run.blocks]), 95)
