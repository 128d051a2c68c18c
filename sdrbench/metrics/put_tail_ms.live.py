"""The block recorder: the entry's start to its upload's end, median over
the window's slowest 5% of blocks by latency (due to outputs on the
host), ms; the open loop's."""

from sdrbench import recorder


def read(run):
    return recorder.host_ms(run, "put", "open", tail=True)
