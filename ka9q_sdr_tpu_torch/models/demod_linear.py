"""Linear demodulator on torch tensors (port of
``ka9q_sdr_tpu.models.demod_linear``, the reference's linear.c).

USB/LSB/CW/IQ/ISB/coherent AM/DSB: everything except FM and envelope AM.
Per block (linear.c:114-310):

1. Optional PLL carrier tracking (linear.c:129-246): an FFT search over
   +-300 Hz sets a coarse offset while the loop is unlocked, a 2nd-order
   lag-lead loop moves a fine NCO once per block from the block's mean
   phase, optional squaring regenerates a DSB carrier, and an SNR
   hysteresis counter detects lock.  The search ring runs at the rate
   decimated by ``acq_decim`` through a half-band cascade, as in the JAX
   package (same 1.37 s window, same 0.73 Hz bins).
2. Per-sample hang AGC on the instantaneous amplitude (linear.c:251-281):
   ops.agc, the Hopper kernel on CUDA.
3. A post-AGC frequency shift for the CW offset (linear.c:283-289).
4. Mono output = I; stereo = (I, Q) (linear.c:291-300).

The acquisition FFT runs only on blocks where some unlocked channel's ring
is due, behind ``utils.graphs.cond(any(do_fft))`` as the JAX package's
``lax.cond``: a locked bank never runs it.  In a captured step the test is
a conditional node the device resolves (the lock state never leaves the
card); the eager step on a card reads it on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.agc import AGCParams, AGCState, agc_block, agc_init
from ..ops.decimate import cascade_init, hb_cascade
from ..ops.nco import OscState, osc_block, osc_init, set_osc, set_osc_traced
from ..utils.graphs import cond

__all__ = ["LinearConfig", "LinearState", "linear_init", "linear_demod"]

#: Carrier search FFT size: 64k = 1.37 s @ 48 kHz (linear.c:43).
PLL_FFT_SIZE = 1 << 16
#: Loop lock threshold, dB SNR (linear.c:42).
SNR_THRESH_DB = 3.0
#: FFT search range, Hz (linear.c:53-54).
SEARCH_HIGH = 300.0


class LinearConfig(NamedTuple):
    """Static configuration derived from a mode table row (modes.txt) and
    the output sample rate.  A copy of the JAX package's host math (its
    module imports jax)."""

    samptime: float       # seconds per decimated sample (linear.c:29)
    blocktime: float      # seconds per block: the TRUE block duration
    #                       (PARITY.md #15; linear.c:30 uses the master L)
    agc: AGCParams
    pll: bool = False
    square: bool = False
    channels: int = 2     # 1 = mono (I only), 2 = stereo (I,Q)
    shift_freq: float = 0.0   # post-AGC shift, cycles/sample (CW offset)
    loop_bw: float = 1.0      # PLL natural frequency, Hz (linear.c:26)
    lock_time: float = 1.0    # lock hysteresis, seconds (linear.c:45)
    acq_decim: int = 1        # acquisition-ring decimation (power of 2)

    @classmethod
    def make(cls, dsamprate: float, block_len: int,
             headroom_db: float = -15.0, recovery_rate_db_s: float = 6.0,
             hangtime_s: float = 1.1, **kw) -> "LinearConfig":
        samptime = 1.0 / dsamprate
        if kw.get("pll", False) and "acq_decim" not in kw:
            # Largest power-of-2 decimation that divides the block, keeps
            # the (squared) search band within 40% of the decimated Nyquist
            # (decimated rate >= 5x the band) and caps at 64.
            search_max = (2.0 if kw.get("square", False) else 1.0) \
                * SEARCH_HIGH
            d = 1
            while (d * 2 <= 64 and block_len % (d * 2) == 0
                   and dsamprate / (d * 2) >= 5.0 * search_max):
                d *= 2
            kw["acq_decim"] = d
        return cls(
            samptime=samptime,
            blocktime=samptime * block_len,
            agc=AGCParams.from_mode(headroom_db, recovery_rate_db_s,
                                    hangtime_s, samptime),
            **kw,
        )

    def to(self, device) -> "LinearConfig":
        """Nothing to place: the configuration is host constants."""
        return self

    # 2nd-order lag-lead loop constants (linear.c:59-65)
    @property
    def integrator_gain(self) -> float:
        natfreq = self.loop_bw * 2.0 * np.pi
        tau1 = 2.0 * np.pi / (natfreq * natfreq)  # vcogain*pdgain/natfreq^2
        return 1.0 / tau1

    @property
    def prop_gain(self) -> float:
        natfreq = self.loop_bw * 2.0 * np.pi
        tau1 = 2.0 * np.pi / (natfreq * natfreq)
        tau2 = 2.0 * (1.0 / np.sqrt(2.0)) / natfreq  # critical damping
        return tau2 / tau1

    @property
    def lock_limit(self) -> int:
        return round(self.lock_time / self.samptime)

    @property
    def binsize(self) -> float:
        # unchanged by acq_decim: the ring covers the same 1.37 s window
        return 1.0 / (PLL_FFT_SIZE * self.samptime)

    @property
    def ring_size(self) -> int:
        return PLL_FFT_SIZE // self.acq_decim

    @property
    def search_bins(self) -> int:
        mult = 2 if self.square else 1
        return round(mult * SEARCH_HIGH / self.binsize)


class LinearState(NamedTuple):
    agc: AGCState
    shift: OscState
    # PLL members (unused tensors stay tiny when pll is off)
    fine: OscState
    coarse: OscState
    integrator: torch.Tensor   # float32 (linear.c:107)
    delta_f: torch.Tensor      # float32, FFT-derived offset, Hz (linear.c:108)
    lock_count: torch.Tensor   # int32 (linear.c:110)
    pll_lock: torch.Tensor     # bool
    snr: torch.Tensor          # float32, previous block's PLL SNR (the lock
    #                            detector reads it next block)
    fft_ring: Optional[torch.Tensor]   # (..., ring_size) complex64, newest
    #                                    last, at the acq_decim rate
    fft_samples: torch.Tensor  # int32, decimated samples since last acq FFT
    foffset: torch.Tensor      # float32, smoothed frequency offset, Hz
    acq_hb: tuple = ()         # half-band cascade overlap states (complex)


def linear_init(cfg: LinearConfig, batch_shape=(), *,
                device) -> LinearState:
    shape = tuple(batch_shape)
    if cfg.pll:
        # Guard configs built without LinearConfig.make: a bad acq_decim
        # breaks the ring-window math.
        d = cfg.acq_decim
        if d < 1 or (d & (d - 1)):
            raise ValueError(f"acq_decim={d} must be a power of two")
        block_len = round(cfg.blocktime / cfg.samptime)
        if block_len % d:
            raise ValueError(
                f"acq_decim={d} does not divide block_len={block_len}")
        if cfg.ring_size <= 2 * cfg.search_bins:
            raise ValueError(
                f"acq_decim={d}: ring_size={cfg.ring_size} cannot hold the "
                f"±{cfg.search_bins}-bin search window; decimate less")
    shift = osc_init(shape, device=device)
    if cfg.shift_freq != 0.0:
        shift = set_osc(shift, cfg.shift_freq)
    fine = osc_init(shape, device=device)

    def zeros(dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LinearState(
        agc=agc_init(100.0, shape, device=device),   # linear.c:39
        shift=shift,
        fine=fine,
        coarse=fine,
        integrator=zeros(torch.float32),
        delta_f=zeros(torch.float32),
        lock_count=zeros(torch.int32),
        pll_lock=zeros(torch.bool),
        snr=zeros(torch.float32),
        fft_ring=(torch.zeros(shape + (cfg.ring_size,), dtype=torch.complex64,
                              device=device) if cfg.pll else None),
        fft_samples=zeros(torch.int32),
        foffset=torch.full(shape, float("nan"), dtype=torch.float32,
                           device=device),
        acq_hb=(tuple(cascade_init(int(np.log2(cfg.acq_decim)),
                                   dtype=torch.complex64, batch_shape=shape,
                                   device=device))
                if cfg.pll and cfg.acq_decim > 1 else ()),
    )


def _acquire(cfg: LinearConfig, ring: torch.Tensor):
    """FFT carrier search (linear.c:178-200).  Returns (delta_f_hz, found).

    |FFT| is invariant under circular rotation, so the unaligned ring is
    transformed directly (as the C does with its circular buffer)."""
    spec = torch.fft.fft(ring, dim=-1)
    energy = spec.real ** 2 + spec.imag ** 2
    nb = cfg.search_bins
    # bins -nb..nb; negative bins wrap to the top of the spectrum
    idx = torch.arange(-nb, nb + 1, device=ring.device) % cfg.ring_size
    window = energy[..., idx]
    rel = torch.argmax(window, dim=-1)       # first maximum, as jnp.argmax
    maxenergy = torch.amax(window, dim=-1)
    maxbin = rel.to(torch.int32) - nb
    delta_f = cfg.binsize * maxbin.to(torch.float32)
    if cfg.square:
        delta_f = delta_f / 2.0   # squaring doubles frequency (linear.c:193)
    return delta_f, maxenergy > 0


def _osc_where(cond: torch.Tensor, new: OscState, old: OscState) -> OscState:
    return OscState(*(torch.where(cond, a, b) for a, b in zip(new, old)))


def _pll_block(cfg: LinearConfig, state: LinearState, baseband: torch.Tensor):
    """Carrier tracking (linear.c:129-246).  Returns (state,
    mixed_baseband, cphase)."""
    n = baseband.shape[-1]

    # Acquisition buffer (linear.c:131-153), decimated by acq_decim
    feed = baseband * baseband if cfg.square else baseband
    acq_hb = state.acq_hb
    if cfg.acq_decim > 1:
        stages = int(np.log2(cfg.acq_decim))
        hb_states, feed = hb_cascade(list(acq_hb), feed, stages)
        feed = feed * (0.5 ** stages)          # unity-DC-gain cascade
        acq_hb = tuple(hb_states)
    nd = feed.shape[-1]
    ring = torch.cat([state.fft_ring[..., nd:], feed], dim=-1)
    fft_samples = torch.clamp_max(state.fft_samples + nd, cfg.ring_size)

    # Lock detector with hysteresis (linear.c:154-170)
    lock_limit = cfg.lock_limit
    lock_count = torch.where(
        state.snr < 10.0 ** (SNR_THRESH_DB / 10.0),
        state.lock_count - n, state.lock_count + n)
    lock_count = torch.clamp(lock_count, -lock_limit, lock_limit)
    pll_lock = torch.where(lock_count >= lock_limit,
                           torch.ones_like(state.pll_lock),
                           torch.where(lock_count <= -lock_limit,
                                       torch.zeros_like(state.pll_lock),
                                       state.pll_lock))

    # Reacquisition (linear.c:173-201).  The search FFT is needed at most
    # 1 block in ring_size/(2n) and never once locked: a scalar cond over
    # the batch skips the whole batched FFT on the other blocks.
    do_fft = (~pll_lock) & (fft_samples > cfg.ring_size // 2)

    def _run_acquire(r):
        acq_df, acq_found = _acquire(cfg, r)
        return torch.where(do_fft, acq_df, state.delta_f), do_fft & acq_found

    new_df, found = cond(
        do_fft.any(),
        _run_acquire,
        lambda r: (state.delta_f, torch.zeros_like(do_fft)),
        ring,
    )
    changed = found & (new_df != state.delta_f)
    delta_f = torch.where(changed, new_df, state.delta_f)
    integrator = torch.where(changed, torch.zeros_like(state.integrator),
                             state.integrator)
    coarse = _osc_where(changed,
                        set_osc_traced(state.coarse, -cfg.samptime * delta_f),
                        state.coarse)
    fft_samples = torch.where(do_fft, torch.zeros_like(fft_samples),
                              fft_samples)

    # Apply coarse+fine offsets; mean phase (linear.c:207-224)
    coarse, lo_c = osc_block(coarse, n)
    fine, lo_f = osc_block(state.fine, n)
    mixed = baseband * lo_c * lo_f
    ss = mixed * mixed if cfg.square else mixed
    accum = torch.sum(ss, dim=-1)
    cphase = torch.angle(accum)
    if cfg.square:
        cphase = cphase / 2.0

    # Lag-lead loop filter, once per block (linear.c:226-245)
    integrator = integrator + cphase * cfg.blocktime
    feedback = cfg.integrator_gain * integrator + cfg.prop_gain * cphase
    fine = set_osc_traced(fine, -feedback * cfg.samptime)

    foffset = torch.where(
        torch.isnan(state.foffset), feedback + delta_f,
        state.foffset + 0.001 * (feedback + delta_f - state.foffset))

    new_state = state._replace(
        fine=fine, coarse=coarse, integrator=integrator, delta_f=delta_f,
        lock_count=lock_count, pll_lock=pll_lock, fft_ring=ring,
        fft_samples=fft_samples, foffset=foffset, acq_hb=acq_hb,
    )
    return new_state, mixed, cphase


def linear_demod(cfg: LinearConfig, state: LinearState,
                 baseband: torch.Tensor):
    """One block (linear.c:114-310).

    baseband: (..., n) complex64 from the slave filter (COMPLEX, or
    CROSS_CONJ per the mode's isb flag).  Returns (state, audio, diag);
    audio is (..., n) float32 for mono or (..., n, 2) for stereo."""
    cphase = torch.zeros(baseband.shape[:-1], dtype=torch.float32,
                         device=baseband.device)
    if cfg.pll:
        state, baseband, cphase = _pll_block(cfg, state, baseband)

    # Power split: signal on I, noise on Q (linear.c:251-258)
    rp = baseband.real ** 2
    ip = baseband.imag ** 2
    signal = torch.sum(rp, dim=-1)
    noise = torch.sum(ip, dim=-1)

    amplitude = torch.sqrt(rp + ip)
    new_agc, gains = agc_block(state.agc, amplitude, cfg.agc)
    out = baseband * gains

    # Post-AGC frequency shift (linear.c:283-289), applied always: at
    # frequency 0 the oscillator is exactly 1+0j
    n = baseband.shape[-1]
    shift, lo = osc_block(state.shift, n)
    out = out * lo

    bb_power = (signal + noise) / (2.0 * n)
    if cfg.pll:
        # noise == 0 is NaN in the C (linear.c:304-309), whose lock test
        # then drifts toward lock; +inf takes the same branch
        snr = torch.where(
            noise > 0,
            torch.clamp_min(signal / torch.clamp_min(noise, 1e-30) - 1.0,
                            0.0),
            torch.full_like(noise, float("inf")))
    else:
        snr = torch.full(baseband.shape[:-1], float("nan"),
                         dtype=torch.float32, device=baseband.device)

    new_state = state._replace(agc=new_agc, shift=shift,
                               snr=snr if cfg.pll else state.snr)
    if cfg.channels == 1:
        audio = out.real.contiguous()
    else:
        audio = torch.stack([out.real, out.imag], dim=-1)

    diag = {
        "bb_power": bb_power,
        "snr": snr,
        "cphase": cphase,
        "foffset": new_state.foffset,
        "pll_lock": new_state.pll_lock,
        "gain": new_agc.gain,
    }
    return new_state, audio, diag
