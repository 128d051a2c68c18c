"""CUDA events on the entry's stream, one recorded before the call and
one after it returns (the upload and the replay), median over the
window's blocks, ms; the closed loop's."""

from sdrbench import yardstick


def read(run):
    if run.loop != "closed":
        return None
    return yardstick.median(d[1] - d[0] for d in run.dev_ms if d is not None)
