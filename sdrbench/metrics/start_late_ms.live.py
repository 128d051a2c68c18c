"""How late the serving loop called the entry after the block was due,
95th percentile over the window's blocks, ms; the open loop's health."""

from sdrbench import yardstick


def read(run):
    if run.loop != "open":
        return None
    return yardstick.percentile(((b.call - b.due) * 1e3 for b in run.blocks),
                                95)
