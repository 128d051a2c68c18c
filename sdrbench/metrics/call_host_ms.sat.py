"""The host clock around the entry call (which holds the block's
synchronous upload), median over the window's blocks, ms; the
closed loop's."""

from sdrbench import yardstick


def read(run):
    if run.loop != "closed":
        return None
    return yardstick.median((b.ret - b.call) * 1e3 for b in run.blocks)
