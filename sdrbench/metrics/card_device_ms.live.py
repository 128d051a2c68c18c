"""A bank on a mesh of cards: each card's device time a block over the
traced span (the union of that card's kernels, copies and sets,
``devtime.reduce_events``) ÷ the blocks served there, the busiest card's,
ms; the open loop's.  None where the trace holds fewer than two cards."""


def read(run):
    t = run.trace
    if run.loop != "open" or not t or not run.traced_blocks:
        return None
    busy = t.get("card_busy_s") or {}
    if len(busy) < 2:
        return None
    return 1e3 * max(busy.values()) / run.traced_blocks
