"""100 x (1 - busy_s / window_s) of the traced span: the share of the
profiler's window in which no kernel, copy or set ran on the card (the
union of the trace's device activity, ``devtime.reduce_events``); the
closed loop's."""

from sdrbench import yardstick


def read(run):
    t = run.trace
    if run.loop != "closed" or not t:
        return None
    return yardstick.idle_pct(t["busy_s"], t["window_s"])
