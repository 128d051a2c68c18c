"""Process start to the window's first block, s."""


def read(run):
    return run.setup_s
