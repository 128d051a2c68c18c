"""The stage marks of the captured step (stamp kernel nodes of its graph,
``utils.trace`` stage ``pack``): each group's PCM (and compaction) and the
state write-back, summed over the groups, median over the traced span's
blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.stage_ms(run, "pack")
