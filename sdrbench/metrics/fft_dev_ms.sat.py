"""The stage marks of the captured step (stamp kernel nodes of its graph,
``utils.trace`` stage ``fft``): the master FFT, median over the traced
span's blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.stage_ms(run, "fft")
