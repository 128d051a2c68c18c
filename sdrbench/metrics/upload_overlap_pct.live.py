"""The program's upload counters (``utils.trace``): the share of the run's
entry uploads copied on the copy stream while the block before ran, %;
the open loop's."""

from sdrbench import uploads


def read(run):
    return uploads.overlap_pct(run, "open")
