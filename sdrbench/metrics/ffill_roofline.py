"""The FM demodulator's two fills (ops.ffill.forward_fill_multi) at the
cell's shapes, timed alone with the L2 flushed: 100 x the least time (the
bytes they must move over the card's memory bandwidth) over the measured
time, %."""

from sdrbench import yardstick


def read(run):
    k = run.kernel.get("ffill")
    if k is None:
        return None
    ms, nbytes = k
    return yardstick.roofline_pct(nbytes, ms * 1e-3, run.device)
