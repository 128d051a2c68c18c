"""CUDA events around the copy of a block's outputs to pinned host
memory, median over the window's blocks, ms; the open loop's."""

from sdrbench import yardstick


def read(run):
    if run.loop != "open":
        return None
    return yardstick.median(d[2] - d[1] for d in run.dev_ms if d is not None)
