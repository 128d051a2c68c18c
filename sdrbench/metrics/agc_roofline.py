"""The linear groups' hang AGC calls (ops.agc.agc_block) at the cell's
shapes, timed alone with the L2 flushed: 100 x the least time (the bytes
they must move over the card's memory bandwidth) over the measured time,
%."""

from sdrbench import yardstick


def read(run):
    k = run.kernel.get("agc")
    if k is None:
        return None
    ms, nbytes = k
    return yardstick.roofline_pct(nbytes, ms * 1e-3, run.device)
