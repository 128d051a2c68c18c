"""CUDA events the program records around the copy into the graph's static
input (``utils.trace`` stage ``stagein``, while the profiler records),
median over the traced span's blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.stage_ms(run, "stagein")
