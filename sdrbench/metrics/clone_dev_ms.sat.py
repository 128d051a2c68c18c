"""CUDA events the program records around the clones of the graph's outputs
(``utils.trace`` stage ``clone``, while the profiler records),
median over the traced span's blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.stage_ms(run, "clone")
