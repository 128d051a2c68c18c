"""The stage marks of the captured step (stamp kernel nodes of its graph,
``utils.trace`` stage ``demod``): each group's demodulator, its gates' IF
nodes included, summed over the groups, median over the traced span's
blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.stage_ms(run, "demod")
