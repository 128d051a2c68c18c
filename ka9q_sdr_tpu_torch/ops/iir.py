"""First-order recurrences as parallel scans, on torch tensors.

Port of ``ka9q_sdr_tpu.ops.iir`` (the AM carrier DC filter, am.c:62, and
the experimental complex notch, filter.c:551-571): the one-pole recurrence
``y_n = (1-a) y_{n-1} + a x_n`` is a linear recurrence, so it is a scan
over ``(decay, drive)`` pairs with the combine
``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``.  Torch has no associative
scan, so this is a Hillis-Steele scan: log2(n) rounds of elementwise ops,
each combining every element with the one 2^r places before it.  It rounds
differently from JAX's ``associative_scan`` (another tree), so the two
agree to float32 accuracy, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .nco import OscState, osc_block, osc_init, set_osc

__all__ = ["one_pole_lowpass", "dc_block", "NotchState", "notch_init",
           "notch_block"]


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


class NotchState(NamedTuple):
    """Experimental IIR complex notch (struct notchfilter, filter.h:96-101)."""

    osc: OscState
    dcstate: torch.Tensor  # complex64 smoothed signal estimate at the notch
    bw: float              # relative bandwidth, rounded to float32 (a host
    #                        number, so a block never reads it off the card)


def notch_init(f: float, bw: float, batch_shape=(), *,
               device) -> NotchState:
    """notch_create (filter.c:551-561); f in cycles/sample.  `batch_shape`
    gives every channel of a batch its own notch state."""
    return NotchState(
        osc=set_osc(osc_init(batch_shape, device=device), f),
        dcstate=torch.zeros(tuple(batch_shape), dtype=torch.complex64,
                            device=device),
        bw=float(np.float32(bw)),
    )


def notch_block(state: NotchState, x: torch.Tensor):
    """Vectorised notch (filter.c:563-571) over the last axis of x: spin
    down by the oscillator, subtract the running DC estimate (pre-update, as
    in the C), update the estimate, spin back up."""
    n = x.shape[-1]
    new_osc, ph = osc_block(state.osc, n)
    u = x * torch.conj(ph)
    # dc_n used for sample n is the *pre-update* state: shift the trace
    dc_last, dc_post = one_pole_lowpass(state.dcstate, u, state.bw)
    dc_pre = torch.cat(
        [state.dcstate[..., None].expand(u.shape[:-1] + (1,)),
         dc_post[..., :-1]], dim=-1)
    out = (u - dc_pre) * ph
    return NotchState(new_osc, dc_last, state.bw), out
