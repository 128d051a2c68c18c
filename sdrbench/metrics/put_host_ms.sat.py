"""The block recorder (the program's ``utils.trace``): the entry's start to
its upload's end, median over the window's blocks, ms; the closed loop's."""

from sdrbench import recorder


def read(run):
    return recorder.host_ms(run, "put", "closed")
