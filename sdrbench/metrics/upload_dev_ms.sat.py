"""CUDA events the program records around the upload's copy in the entry's
``_put`` (``utils.trace`` stage ``upload``, while the profiler records),
median over the traced span's blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.stage_ms(run, "upload")
