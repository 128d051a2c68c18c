"""The program's capture records (``utils.trace``): the seconds of every
CUDA-graph capture of the run (the warm-up run and the capture of each
entry variant at set-up), s."""

from sdrbench import recorder


def read(run):
    return recorder.capture_s()
