"""First-order recurrences as parallel scans, on torch tensors.

Port of ``ka9q_sdr_tpu.ops.iir`` (the AM carrier DC filter, am.c:62): the
one-pole recurrence ``y_n = (1-a) y_{n-1} + a x_n`` is a linear
recurrence, so it is a scan over ``(decay, drive)`` pairs with the combine
``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``.  Torch has no associative
scan, so this is a Hillis-Steele scan: log2(n) rounds of elementwise ops,
each combining every element with the one 2^r places before it.  It rounds
differently from JAX's ``associative_scan`` (another tree), so the two
agree to float32 accuracy, not bit for bit.

The experimental notch (iir.py:59-92) is on no bank path and is not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["one_pole_lowpass", "dc_block"]


def _scan_last(decay: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """Inclusive Hillis-Steele scan of (decay, drive) along the last axis;
    returns the drive component (the filtered sequence)."""
    n = drive.shape[-1]
    d = 1
    while d < n:
        drive = torch.cat(
            [drive[..., :d], decay[..., d:] * drive[..., :-d] + drive[..., d:]],
            dim=-1)
        decay = torch.cat([decay[..., :d], decay[..., :-d] * decay[..., d:]],
                          dim=-1)
        d *= 2
    return drive


def one_pole_lowpass(y0: torch.Tensor, x: torch.Tensor, alpha: float,
                     axis: int = -1):
    """y_n = y_{n-1} + alpha * (x_n - y_{n-1}), returning (y_last, y).

    y_n includes the update from x_n (post-update value), matching the
    reference's ``state += alpha * (x - state)`` then read-back ordering."""
    x = torch.movedim(x, axis, -1)
    a = float(np.float32(alpha))
    one_minus = float(np.float32(1.0) - np.float32(alpha))
    decay = torch.full(x.shape, one_minus, dtype=x.dtype, device=x.device)
    drive = a * x
    # fold the initial condition into the first element
    drive = torch.cat([(drive[..., 0] + one_minus * y0)[..., None],
                       drive[..., 1:]], dim=-1)
    y = _scan_last(decay, drive)
    return y[..., -1], torch.movedim(y, -1, axis)


def dc_block(dc0: torch.Tensor, x: torch.Tensor, coeff: float):
    """AM carrier removal (am.c:60-62,74): tracks the envelope DC with a
    one-pole filter and returns (dc_last, dc_trace), dc_trace[n] being the
    post-update DC estimate used for sample n."""
    return one_pole_lowpass(dc0, x, coeff)
