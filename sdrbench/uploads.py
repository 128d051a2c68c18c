"""The program's upload counters (``ka9q_sdr_tpu_torch.utils.trace``
``upload_overlapped`` and ``upload_inline``: the entries' uploads,
process-wide, copied on a copy stream while the block before ran or
copied synchronously), read once a run has ended.  A program without
them (an older checkout) gives None, and the metrics that read them are
left out of the result line."""

from __future__ import annotations

from . import recorder


def overlap_pct(run, loop: str) -> float | None:
    """100 x overlapped / (overlapped + inline) over the run's uploads, set-up
    included, for a run of `loop`; None where the program counts none."""
    if run.loop != loop:
        return None
    tr = recorder.program_trace()
    overlapped = getattr(tr, "upload_overlapped", None)
    inline = getattr(tr, "upload_inline", None)
    if overlapped is None or inline is None or overlapped + inline == 0:
        return None
    return 100.0 * overlapped / (overlapped + inline)
