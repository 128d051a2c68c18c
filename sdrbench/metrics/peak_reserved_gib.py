"""torch.cuda.max_memory_reserved over the program's set-up and the
window (the peak is reset once the traffic loop is made), GiB."""


def read(run):
    if run.peak_reserved <= 0:
        return None
    return run.peak_reserved / 2**30
