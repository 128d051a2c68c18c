"""The block recorder (the program's ``utils.trace``): the upload's end to
the entry's end (the static-input copy, the replay's launch and the
clones), median over the window's blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.host_ms(run, "launch", "closed")
