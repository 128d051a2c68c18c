"""Hang AGC: the reference's per-sample gain recurrence, on torch tensors.

Port of ``ka9q_sdr_tpu.ops.agc`` (am.c:26-30,64-74, linear.c:33-39,269-280):

- if the current level would exceed headroom, clamp the gain to
  headroom/level and start the hang timer (instant attack);
- while the hang timer runs, hold the gain;
- otherwise ramp the gain up by `recovery_factor` per sample.

The recurrence is serial in time and independent per channel.  Two
implementations of ``agc_block``:

- ``agc_plain``: a loop over the samples on (B,) tensors, the same float32
  operations in the same order as the JAX package's scan step.  It runs for
  CPU tensors, and it is what the tests and ``chip_smoke.py`` hold the
  kernel against.
- the Hopper kernel in ``csrc/agc.cu``: one walker lane per channel runs
  the recurrence in registers over fully unrolled tiles of 32 samples,
  while two helper warps per 32 channels stream the levels in through an
  asynchronous ring in shared memory, divide the clamps ahead of the walk
  and store the gains.  It runs for every CUDA tensor, at every size.

Both are IEEE float32 with no fused multiply-add in the step, and the
clamp is the same correctly rounded quotient wherever it is computed, so
they agree bit for bit.  ``agc_block`` checks its arguments the same way
for both and raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["db2voltage", "AGCParams", "AGCState", "agc_init", "agc_block",
           "agc_plain", "agc_block_coarse"]

#: Kernel launches so far (one per ``agc_block`` call on CUDA tensors);
#: ``chip_smoke.py`` resets and reads it to show a path went through the
#: kernel.
launches = 0


def db2voltage(db: float) -> float:
    """dB to voltage ratio (misc.h's dB2voltage)."""
    return float(np.power(10.0, db / 20.0))


class AGCParams(NamedTuple):
    """Static AGC configuration derived from the mode table."""

    headroom: float          # target peak level (voltage ratio)
    recovery_factor: float   # per-sample gain ramp (voltage ratio > 1)
    hangmax: int             # samples to hold after a clamp

    @classmethod
    def from_mode(cls, headroom_db: float, recovery_rate_db_s: float,
                  hangtime_s: float, samptime: float) -> "AGCParams":
        """Mirror the derivations of am.c:27-29 / linear.c:34-38."""
        return cls(
            headroom=db2voltage(headroom_db),
            recovery_factor=db2voltage(recovery_rate_db_s * samptime),
            hangmax=int(hangtime_s / samptime),
        )


class AGCState(NamedTuple):
    gain: torch.Tensor       # float32, current voltage gain
    hangcount: torch.Tensor  # int32, remaining hang samples


def agc_init(initial_gain_db: float = 80.0, batch_shape=(), *,
             device) -> AGCState:
    """Initial gain is 80 dB for AM (am.c:30), 100 dB for linear
    (linear.c:39)."""
    shape = tuple(batch_shape)
    return AGCState(
        gain=torch.full(shape, db2voltage(initial_gain_db),
                        dtype=torch.float32, device=device),
        hangcount=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def _f32(x: float) -> float:
    """A host constant rounded to float32, as the JAX package uses it."""
    return float(np.float32(x))


def agc_plain(gain: torch.Tensor, hang: torch.Tensor, level: torch.Tensor,
              params: AGCParams):
    """The recurrence as a loop over the last axis of `level` (B, T).
    Returns (gains (B, T), gain (B,), hang (B,))."""
    headroom = _f32(params.headroom)
    recovery = _f32(params.recovery_factor)
    # a tensor numerator: torch computes `number / tensor` as a reciprocal
    # times the number, which is not the correctly rounded quotient (a fill,
    # not a host-to-device copy, which would wait for the stream)
    headroom_t = torch.full((), headroom, dtype=torch.float32,
                            device=level.device)
    hangmax = torch.full_like(hang, params.hangmax)
    zero = torch.zeros_like(hang)
    out = torch.empty_like(level)
    for t in range(level.shape[-1]):
        lev = level[:, t]
        clamp_gain = headroom_t / lev
        over = lev * gain > headroom
        bad = torch.isnan(gain)
        gain = torch.where(bad | over, clamp_gain,
                           torch.where(hang > 0, gain, gain * recovery))
        hang = torch.where(over & ~bad, hangmax, torch.maximum(hang - 1, zero))
        out[:, t] = gain
    return out, gain, hang


def _agc_cuda(gain, hang, level, params: AGCParams):
    """Launch csrc/agc.cu on (B, T) level and (B,) carries."""
    global launches
    from . import _kernels

    fn = _kernels.load("agc").lib.agc_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    B, T = level.shape
    out = torch.empty_like(level)
    gain_out = torch.empty_like(gain)
    hang_out = torch.empty_like(hang)
    with torch.cuda.device(level.device):
        err = fn(level.data_ptr(), gain.data_ptr(), hang.data_ptr(),
                 out.data_ptr(), gain_out.data_ptr(), hang_out.data_ptr(),
                 B, T, _f32(params.headroom), _f32(params.recovery_factor),
                 int(params.hangmax),
                 torch.cuda.current_stream(level.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"agc kernel launch failed (error {err})")
    launches += 1
    return out, gain_out, hang_out


def _check(state: AGCState, level: torch.Tensor) -> None:
    """Raise on what the kernel does not take (both implementations)."""
    if level.dtype != torch.float32 or level.ndim < 1:
        raise TypeError(f"AGC level must be float32 of rank >= 1, not "
                        f"{level.dtype} of rank {level.ndim}")
    lead = level.shape[:-1]
    if state.gain.dtype != torch.float32 or state.gain.shape != lead:
        raise ValueError(f"gain must be float32 of shape {tuple(lead)}")
    if state.hangcount.dtype != torch.int32 or state.hangcount.shape != lead:
        raise ValueError(f"hangcount must be int32 of shape {tuple(lead)}")
    if not (state.gain.device == state.hangcount.device == level.device):
        raise ValueError("AGC state and level must share one device")
    if level.shape[-1] == 0:
        raise ValueError("AGC level has no samples")


def agc_block(state: AGCState, level: torch.Tensor,
              params: AGCParams) -> tuple[AGCState, torch.Tensor]:
    """Per-sample hang AGC over a block.

    `level` is the control signal per sample (the envelope DC estimate for
    AM, the instantaneous amplitude for linear), shape (..., n).  Returns
    (new_state, gain_per_sample): gain[n] is the post-update gain applied
    to sample n (the C ordering).  CUDA tensors go to the Hopper kernel,
    CPU tensors to ``agc_plain``."""
    _check(state, level)
    lead, T = level.shape[:-1], level.shape[-1]
    lev = level.reshape(-1, T).contiguous()
    gain = state.gain.reshape(-1).contiguous()
    hang = state.hangcount.reshape(-1).contiguous()
    if level.device.type == "cuda":
        out, gain, hang = _agc_cuda(gain, hang, lev, params)
    elif level.device.type == "cpu":
        out, gain, hang = agc_plain(gain, hang, lev, params)
    else:
        raise ValueError(f"no AGC for device {level.device}")
    return (AGCState(gain.reshape(lead), hang.reshape(lead)),
            out.reshape(level.shape))


def _f32_int_pow(x: float, n: int) -> float:
    """float32 x**n by square-and-multiply, the product order of JAX's
    integer_pow (which a float32 ``x ** n`` with an int n lowers to)."""
    x, acc = np.float32(x), None
    while n > 0:
        if n & 1:
            acc = x if acc is None else np.float32(acc * x)
        n >>= 1
        if n > 0:
            x = np.float32(x * x)
    return float(np.float32(1.0) if acc is None else acc)


def agc_block_coarse(state: AGCState, level: torch.Tensor,
                     params: AGCParams) -> tuple[AGCState, torch.Tensor]:
    """Block-rate AGC approximation: one gain update per block driven by
    the block peak level (kept for experiments, as in the JAX package; no
    model uses it)."""
    n = level.shape[-1]
    peak = torch.amax(level, dim=-1)
    headroom = _f32(params.headroom)
    recovery_blk = _f32_int_pow(params.recovery_factor, n)
    over = peak * state.gain > headroom
    bad = torch.isnan(state.gain)
    new_gain = torch.where(
        bad | over, torch.full_like(peak, headroom) / peak,
        torch.where(state.hangcount > 0, state.gain,
                    state.gain * recovery_blk))
    new_hang = torch.where(
        over & ~bad, torch.full_like(state.hangcount, params.hangmax),
        torch.clamp_min(state.hangcount - n, 0))
    gains = new_gain[..., None].expand(level.shape).clone()
    return AGCState(new_gain, new_hang), gains
