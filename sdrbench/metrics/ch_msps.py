"""channels x Msps served in the window: n_channels x L x the blocks whose
outputs reached the host within it (their copy's completion event), over
the window's seconds, / 1e6.  A closed loop's metric."""

from sdrbench import yardstick


def read(run):
    if run.loop != "closed":
        return None
    done = [d[2] for d in run.dev_ms if d is not None]
    n = yardstick.blocks_within(done, run.seconds)
    return yardstick.ch_msps(run.n_channels, run.L, n, run.seconds)
