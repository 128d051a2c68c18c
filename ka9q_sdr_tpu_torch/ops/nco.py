"""Phase-continuous complex NCO as vectorised phase ramps, on torch tensors.

Port of ``ka9q_sdr_tpu.ops.nco`` (the reference oscillator, osc.c).  The
phase accumulator is fixed point in units of 2^-32 cycles: integer
multiply-add wraps mod 2^32, which is exactly "phase mod 1 cycle", so phase
stays continuous across blocks and retunes with no drift.  The sub-ulp
residuals and the sweep rate are float32, as in the JAX package.

torch.uint32 supports few operations, so the uint32 words of the JAX
package (phase, freq) are carried as int64 holding a value in [0, 2^32):
every update is masked with ``& _MASK``.  The int64 -> float32 conversion
rounds to nearest-even like JAX's uint32 -> float32, and torch.round rounds
half to even like jnp.round, so the words and the phase ramp are bit-exact
against the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "OscState",
    "osc_init",
    "set_osc",
    "set_osc_traced",
    "split_double",
    "phase_ramp",
    "osc_block",
    "nco_mix",
    "osc_advance",
]

_TWO32 = float(2**32)
_MASK = 0xFFFFFFFF
_INV32 = float(np.float32(1.0 / _TWO32))


class OscState(NamedTuple):
    """Functional oscillator state (cf. struct osc, osc.h:9-17)."""

    phase: torch.Tensor        # int64 in [0, 2^32), phase in 2^-32 cycles
    freq: torch.Tensor         # int64 in [0, 2^32), 2^-32 cycles/sample
    freq_resid: torch.Tensor   # float32, sub-ulp frequency residual
    rate: torch.Tensor         # float32, sweep rate (cycles/sample^2)
    phase_resid: torch.Tensor  # float32, sub-ulp phase residual (cycles)


def split_double(f: float) -> tuple[int, float]:
    """Split a float64 frequency (cycles/sample) into a uint32 fixed-point
    part and a float32-safe residual.  |residual| <= 2^-33 cycles/sample."""
    fm = float(np.float64(f) % 1.0)
    hi_raw = int(np.round(fm * _TWO32))
    # residual against the UNWRAPPED rounding: fm within 2^-33 below 1.0
    # rounds to 2^32 -> hi 0, and the residual must be the tiny negative
    # remainder, not ~1.0
    resid = float(fm - hi_raw / _TWO32)
    return hi_raw % (2**32), resid


def _f32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``x.astype(int32).astype(uint32)`` for a rounded float32: a
    saturating conversion to int32, then the two's-complement wrap."""
    return x.to(torch.int64).clamp(-2**31, 2**31 - 1) & _MASK


def osc_init(batch_shape=(), *, device) -> OscState:
    """Zero-frequency oscillator with phase 0 (phasor = 1)."""
    shape = tuple(batch_shape)
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return OscState(
        phase=torch.zeros(shape, **i64),
        freq=torch.zeros(shape, **i64),
        freq_resid=torch.zeros(shape, **f32),
        rate=torch.zeros(shape, **f32),
        phase_resid=torch.zeros(shape, **f32),
    )


def set_osc(state: OscState, f: float, r: float = 0.0) -> OscState:
    """Retune without phase jump (set_osc, osc.c:22-36).

    f in cycles/sample, r in cycles/sample^2, both host floats (retunes are
    control-plane events).  The existing phase accumulator is preserved."""
    hi, resid = split_double(f)
    like = state.phase
    return OscState(
        phase=state.phase,
        freq=torch.full_like(like, hi),
        freq_resid=torch.full(like.shape, resid, dtype=torch.float32,
                              device=like.device),
        rate=torch.full(like.shape, r, dtype=torch.float32,
                        device=like.device),
        phase_resid=state.phase_resid,
    )


def set_osc_traced(state: OscState, f: torch.Tensor, r=0.0) -> OscState:
    """Retune from a device-side float32 frequency (the PLL's per-block
    set_osc calls, linear.c:198,234).

    Control-loop frequencies are small (|f| << 1), so the whole frequency
    lives in the float32 residual; the fixed-point word is zeroed.  Phase is
    preserved.  osc_advance folds the residual into the exact accumulator
    every block."""
    shape = state.phase.shape
    f = torch.as_tensor(f, dtype=torch.float32, device=state.phase.device)
    r = torch.as_tensor(r, dtype=torch.float32, device=state.phase.device)
    return OscState(
        phase=state.phase,
        freq=torch.zeros_like(state.phase),
        freq_resid=f.expand(shape).clone(),
        rate=r.expand(shape).clone(),
        phase_resid=state.phase_resid,
    )


def phase_ramp(state: OscState, n: int) -> torch.Tensor:
    """Phases (in cycles, float32) of the next n oscillator samples.

    phase_k = phi0 + k*f + k(k-1)/2 * r, with the integer part in exact
    2^-32-cycle fixed point and the residual/sweep parts in float32.  Leaves
    of shape (...,) produce a (..., n) ramp."""
    dev = state.phase.device
    k = torch.arange(n, dtype=torch.int64, device=dev)
    fixed = (state.phase[..., None]
             + ((k * state.freq[..., None]) & _MASK)) & _MASK
    kf = torch.arange(n, dtype=torch.float32, device=dev)
    frac = (
        state.phase_resid[..., None]
        + kf * state.freq_resid[..., None]
        + (kf * (kf - 1.0) * 0.5) * state.rate[..., None]
    )
    return fixed.to(torch.float32) * _INV32 + frac


def osc_block(state: OscState, n: int) -> tuple[OscState, torch.Tensor]:
    """Next n oscillator samples as complex64, plus the advanced state.

    Equivalent to n calls of step_osc (osc.c:39-51), vectorised."""
    ang = (2.0 * np.pi) * phase_ramp(state, n)
    out = torch.complex(torch.cos(ang), torch.sin(ang))
    return osc_advance(state, n), out


def osc_advance(state: OscState, n: int) -> OscState:
    """Advance the oscillator by n samples without generating output (the
    reference keeps LOs stepping through zero-filled gaps, radio.c:88-99)."""
    nf = float(np.float32(n))
    # the JAX package evaluates nf*(nf-1)*0.5 in float32
    sweep = float(np.float32(np.float32(nf) * np.float32(nf - 1.0))
                  * np.float32(0.5))
    extra = (
        state.phase_resid
        + nf * state.freq_resid
        + sweep * state.rate
    )
    # drop whole cycles BEFORE the fixed-point conversion (phase is modulo
    # one cycle, so the fold is exact; see the JAX package's osc_advance)
    extra = extra - torch.round(extra)
    extra_fx = torch.round(extra * _TWO32)
    new_phase = (
        state.phase + ((n * state.freq) & _MASK) + _f32_to_u32(extra_fx)
    ) & _MASK
    new_phase_resid = extra - extra_fx * _INV32
    # frequency advance from sweep: f' = f + n*r, renormalising the residual
    y = state.freq_resid + nf * state.rate
    df = torch.round(y * _TWO32)
    new_freq = (state.freq + _f32_to_u32(df)) & _MASK
    new_resid = y - df * _INV32
    return OscState(new_phase, new_freq, new_resid, state.rate, new_phase_resid)


def nco_mix(state: OscState, x: torch.Tensor) -> tuple[OscState, torch.Tensor]:
    """Multiply a block by the oscillator (the per-sample
    `samp *= step_osc(...)` of radio.c:132-136, vectorised)."""
    new_state, lo = osc_block(state, x.shape[-1])
    return new_state, x * lo
