"""Wideband multichannel bank on torch tensors, every mode of the table.

Port of ``ka9q_sdr_tpu.models.bank``: ONE wideband forward FFT per block,
then for every channel a bin gather (frequency conversion done in the
frequency domain), the shared frequency response, the exact integer block
phase, a batched short IFFT, a residual fine-tune NCO at the decimated rate,
and the batched demodulator of the bank's mode (FM, AM or linear).  See the
JAX module's docstring for the frequency-conversion algebra; the port
computes the same math.  Live control (retune, Doppler steer, demod-row
reset, filter swap) edits the state between blocks.

What differs from the JAX package, by design:

- The per-channel window gather is the plain one, ``fdomain[(base_idx + k)
  % N]``.  The JAX package's aligned 128-bin chunk-row gather with its
  shifted-response table exists because the TPU has no fast dynamic gather.
  ISB banks combine the sidebands from that gather (``_isb_combine``).
- Block-phase residues are computed in int64, where ``(s * c) % N`` is exact;
  the JAX package's int32 limb arithmetic (``_mul_mod_n``) only avoided
  int32 overflow.
- State keeps complex tensors: there is no real-dtype packing boundary.
- ``MultiBank`` holds ONE wideband overlap tensor, the same tensor in
  every group's state (the JAX package keeps a copy per group and reads
  group 0's); on a mesh, one per device.
- On a mesh (``parallel.mesh``) the state is a tuple of per-device
  BankStates and live control edits the shard that owns the channel.
- The host wrappers replay a captured CUDA graph of each step where the
  JAX wrappers jit it (``utils.graphs``); their state is static, so live
  control writes into it.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_execute,
    set_filter_response,
    slave_bin_indices,
)
from ..ops.nco import OscState, osc_block, osc_init, set_osc, split_double
from ..utils import trace
from ..utils.graphs import (StepGraphs, clone_tree, scan, static_copy,
                            write_state)
from ..utils.modes import DEFAULT_MODES, ModeDef
from .demod_am import AMConfig, am_demod, am_init
from .demod_fm import FMConfig, fm_demod, fm_init
from .demod_linear import LinearConfig, linear_demod, linear_init

__all__ = [
    "BankConfig",
    "BankState",
    "ChannelBank",
    "make_bank_config",
    "bank_init",
    "bank_step",
    "bank_step_i16",
    "bank_step_active",
    "bank_channelize",
    "bank_demod",
    "bank_recenter",
    "bank_tune",
    "bank_set_doppler",
    "bank_reset_demod_row",
    "swap_filter_response",
    "iq_from_i16",
    "MultiBank",
    "multibank_step",
    "make_bank",
]

_TWO32 = float(2**32)
_MASK = 0xFFFFFFFF


class BankConfig(NamedTuple):
    """Static channel-bank configuration (see the JAX package's
    BankConfig).  `to(device)` places the per-block constants on a device."""

    samprate: float
    master: MasterSpec
    decimate: int
    mode: ModeDef
    n_channels: int
    response: np.ndarray     # shared (N_dec,) channel frequency response
    base_idx: object         # (N_dec,) master-bin gather pattern at k=0
    demod_cfg: object        # FMConfig, AMConfig or LinearConfig
    kaiser_beta: float = 3.0

    @property
    def N(self) -> int:
        return self.master.N

    @property
    def N_dec(self) -> int:
        return self.master.N // self.decimate

    @property
    def L_dec(self) -> int:
        return self.master.L // self.decimate

    @property
    def dsamprate(self) -> float:
        return self.samprate / self.decimate

    def to(self, device) -> "BankConfig":
        """This config with the gather pattern and the demodulator's
        responses as tensors on `device`, so a block uploads nothing."""
        return self._replace(
            base_idx=torch.as_tensor(np.asarray(self.base_idx, np.int64),
                                     device=device),
            demod_cfg=self.demod_cfg.to(device),
        )


class BankState(NamedTuple):
    overlap: torch.Tensor   # (M-1,) complex64, shared wideband overlap
    resp: torch.Tensor      # (N_dec,) complex64, shared channel response
    k: torch.Tensor         # (B,) int32, per-channel integer bin shift
    r: torch.Tensor         # (B,) int32, per-channel block-phase residue mod N
    dr: torch.Tensor        # (B,) int32, per-block residue step (k*L mod N)
    nco: OscState           # batched (B,) residual fine-tune oscillators
    demod: object           # batched demod state (FM-, AM- or LinearState)
    gain_factor: torch.Tensor  # float32 scalar


def _out_type(mode: ModeDef) -> FilterType:
    """CROSS_CONJ for the ISB modes (filter.c:239-249), else COMPLEX."""
    if mode.demod == "LINEAR" and mode.isb:
        return FilterType.CROSS_CONJ
    return FilterType.COMPLEX


def make_bank_config(
    n_channels: int,
    mode: str | ModeDef = "FM",
    samprate: float = 24.576e6,
    L: int = 491520,
    M: int = 557057,
    kaiser_beta: float = 3.0,
    headroom_db: float = -15.0,
    enable_pl: bool = False,
) -> BankConfig:
    if isinstance(mode, str):
        mode = DEFAULT_MODES[mode.upper()]
    master = MasterSpec(L, M, FilterType.COMPLEX)
    N = master.N
    # Channel geometry mirrors the reference receiver: 48 kHz output.
    decimate = round(samprate / 48000.0)
    if N % decimate:
        raise ValueError(f"N={N} not divisible by decimate={decimate}")
    slave = SlaveSpec(master, decimate, _out_type(mode))
    dsamprate = samprate / decimate
    response = set_filter_response(
        slave, mode.low / dsamprate, mode.high / dsamprate, kaiser_beta
    )
    base_idx = slave_bin_indices(slave).astype(np.int32)
    L_dec = L // decimate
    M_dec = (M - 1) // decimate + 1
    if mode.demod == "FM":
        demod_cfg = FMConfig.make(
            dsamprate, mode.low, mode.high, L_dec, M_dec,
            headroom_db=headroom_db, kaiser_beta=kaiser_beta,
            flat=mode.flat, enable_pl=enable_pl and not mode.flat,
        )
    elif mode.demod == "AM":
        demod_cfg = AMConfig.make(
            dsamprate, headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate, hangtime_s=mode.hangtime,
        )
    else:
        demod_cfg = LinearConfig.make(
            dsamprate, L_dec, headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate, hangtime_s=mode.hangtime,
            pll=mode.pll, square=mode.square, channels=mode.channels,
            shift_freq=mode.shift / dsamprate,
        )
    return BankConfig(
        samprate=float(samprate),
        master=master,
        decimate=decimate,
        mode=mode,
        n_channels=n_channels,
        response=response,
        base_idx=base_idx,
        demod_cfg=demod_cfg,
        kaiser_beta=kaiser_beta,
    )


def _residual_phase_cycles(cfg: BankConfig, delta: float) -> float:
    """Group-delay phase correction for off-bin tuning, in cycles: the
    shared linear-phase response (delay (M_dec-1)/2 output samples) is
    sampled delta off from where the reference samples it, which costs the
    constant per-channel phase delta*(M-1)/2 folded into the residual NCO."""
    return delta * (cfg.master.M - 1) / 2.0


def _osc_with_phase(osc: OscState, cycles: float) -> OscState:
    """Return osc with `cycles` added to its phase accumulator (split into
    the fixed-point word + float32 residual exactly like frequencies)."""
    hi, resid = split_double(cycles)
    return osc._replace(
        phase=(osc.phase + hi) & _MASK,         # wraps mod 1 cycle
        phase_resid=osc.phase_resid + resid,
    )


def bank_init(cfg: BankConfig, freqs_hz: Sequence[float], *,
              device) -> BankState:
    """Initial state with every channel tuned (host-side design time)."""
    B = cfg.n_channels
    if len(freqs_hz) != B:
        raise ValueError(f"need {B} frequencies, got {len(freqs_hz)}")
    N = cfg.N
    ks, ncos = [], []
    for i, f in enumerate(freqs_hz):
        if not np.isfinite(f) or abs(f) > cfg.samprate / 2:
            raise ValueError(
                f"channel {i}: frequency {f!r} Hz outside the "
                f"+-{cfg.samprate / 2:.0f} Hz span of a "
                f"{cfg.samprate:.0f} S/s bank"
            )
        nu = f / cfg.samprate
        k = int(np.round(nu * N))
        delta = nu - k / N
        ks.append(k % N)
        # residual LO at the decimated rate; negative = downconvert.
        # Initial phase = the off-bin group-delay correction.
        osc = set_osc(osc_init(device="cpu"), -delta * cfg.decimate)
        ncos.append(_osc_with_phase(osc, _residual_phase_cycles(cfg, delta)))
    nco = OscState(*(torch.stack(leaf).to(device) for leaf in zip(*ncos)))
    ks64 = np.asarray(ks, np.int64)
    # r_0 = k*(0*L - (M-1)) mod N  (chunk 0 starts at sample -(M-1))
    r0 = (-(cfg.master.M - 1) * ks64) % N
    dr0 = (ks64 * cfg.master.L) % N

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    if cfg.mode.demod == "FM":
        dstate = fm_init(cfg.demod_cfg, (B,), device=device)
    elif cfg.mode.demod == "AM":
        dstate = am_init((B,), device=device)
    else:
        dstate = linear_init(cfg.demod_cfg, (B,), device=device)

    return BankState(
        overlap=torch.zeros((cfg.master.M - 1,), dtype=torch.complex64,
                            device=device),
        resp=torch.as_tensor(cfg.response, dtype=torch.complex64,
                             device=device),
        k=i32(ks64),
        r=i32(r0),
        dr=i32(dr0),
        nco=nco,
        demod=dstate,
        gain_factor=torch.ones((), dtype=torch.float32, device=device),
    )


def bank_recenter(cfg: BankConfig, state: BankState) -> BankState:
    """Integer-k re-centering for swept (Doppler-steered) channels.

    Once a channel's residual NCO frequency drifts past 3/4 of a master bin,
    hop k by the whole-bin excess s, phase-continuously: k += s,
    dr += s*L mod N, r -= s*(M-1) mod N, the NCO gives back s bins, and the
    group-delay correction for the delta change lands on phase_resid.  See
    the JAX package's bank_recenter for the derivation."""
    N, N_dec = cfg.N, cfg.N_dec
    nco = state.nco
    fw = torch.where(nco.freq >= 2**31, nco.freq - 2**32, nco.freq)
    fq = fw.to(torch.float32) * (1.0 / _TWO32) + nco.freq_resid
    x = -fq * float(N_dec)                       # bins above k
    s = torch.where(torch.abs(x) > 0.75, torch.round(x).to(torch.int64),
                    torch.zeros_like(nco.freq))
    k_new = (state.k + s) % N
    dr_new = (state.dr + (s % N) * (cfg.master.L % N)) % N
    r_new = (state.r - (s % N) * ((cfg.master.M - 1) % N)) % N
    hi1, res1 = split_double(1.0 / N_dec)
    freq_new = (nco.freq + s * hi1) & _MASK
    resid_new = nco.freq_resid + s.to(torch.float32) * float(np.float32(res1))
    # dcorr = -s*Dhalf/N cycles (group-delay correction, exact int mod)
    d_half = (cfg.master.M - 1) // 2
    ph_cycles = (((-s) % N) * (d_half % N) % N).to(torch.float32) \
        * float(np.float32(1.0 / N))
    return state._replace(
        k=k_new.to(torch.int32),
        dr=dr_new.to(torch.int32),
        r=r_new.to(torch.int32),
        nco=nco._replace(
            freq=freq_new,
            freq_resid=resid_new,
            phase_resid=nco.phase_resid + ph_cycles,
        ),
    )


def bank_channelize(
    cfg: BankConfig, state: BankState, fdomain,
) -> tuple[torch.Tensor, OscState, torch.Tensor]:
    """Shared-FFT channel extraction: gather + response + block phase +
    batched IFFT + residual NCO.  Returns (new_r, new_nco, baseband) with
    baseband (B, L_dec) complex64.

    fdomain: the (N,) spectrum, or the distributed FFT's comb slices (a
    list from ``parallel.dfft.make_dfft_sm``), from which each channel's
    bins are gathered where they live (the JAX package's ``bin_perm``, a
    permuted spectrum read through an index, has no twin: the sharded step
    reads the comb slices)."""
    return _channelize_bins(cfg, state, _gather(cfg, state, fdomain))


def _gather_index(cfg: BankConfig, state: BankState) -> torch.Tensor:
    """(B, N_dec) true-bin indices: each channel's window of the master
    spectrum."""
    base = torch.as_tensor(cfg.base_idx, dtype=torch.int64,
                           device=state.k.device)
    return (base[None, :] + state.k[:, None]) % cfg.N


def _gather(cfg: BankConfig, state: BankState, fdomain) -> torch.Tensor:
    """(B, N_dec) bins of every channel's window, from the spectrum or its
    comb slices (bank_channelize)."""
    idx = _gather_index(cfg, state)
    if isinstance(fdomain, torch.Tensor):
        return fdomain[idx]
    from ..parallel.dfft import comb_gather

    return comb_gather(fdomain, idx)


def _channelize_bins(cfg: BankConfig, state: BankState,
                     gathered: torch.Tensor):
    """bank_channelize from the gathered (B, N_dec) bins."""
    N, N_dec, L_dec = cfg.N, cfg.N_dec, cfg.L_dec
    # the JAX package's expression: f32 residue, complex64 exponent
    phi = torch.exp((-2j * np.pi / N) * state.r.to(torch.float32))
    new_r = (state.r + state.dr) % N
    new_nco, lo = osc_block(state.nco, L_dec)
    f_fd = gathered * state.resp[None, :] * phi[:, None]
    if _out_type(cfg.mode) is FilterType.CROSS_CONJ:
        return new_r, new_nco, _isb_combine(f_fd, lo, N_dec, L_dec)
    y = torch.fft.ifft(f_fd, dim=-1) * N_dec
    return new_r, new_nco, y[..., N_dec - L_dec:] * lo


def _isb_combine(f_fd: torch.Tensor, lo: torch.Tensor, N_dec: int,
                 L_dec: int) -> torch.Tensor:
    """CROSS_CONJ ISB combine from a slave-order spectrum.

    The reference mixes the full LO before its FFT, so its cross-conjugate
    combine (filter.c:239-249, pairing slave bins p = 1..h-1 with N_dec-p
    and leaving 0 and h unpaired) sees the residual-shifted sidebands; conj
    does not commute with that shift.  So the sidebands are transformed
    apart, each mixed with the residual LO, and combined after:
    out = base + 2j*Im(USB') + 2*Re(LSB'), base = the unpaired DC/Nyquist
    bins."""
    h = N_dec // 2
    f_pos = f_fd.clone()
    f_pos[..., h + 1:] = 0
    f_neg = f_fd.clone()
    f_neg[..., : h + 1] = 0
    u = torch.fft.ifft(f_pos, dim=-1)[..., N_dec - L_dec:] * N_dec
    l_ = torch.fft.ifft(f_neg, dim=-1)[..., N_dec - L_dec:] * N_dec
    # (-1)^n built on the device: a host array copied in would wait for
    # the stream on every block
    n_out = torch.arange(N_dec - L_dec, N_dec, device=f_fd.device)
    sign = (1 - 2 * (n_out % 2)).to(torch.float32)
    base = f_fd[..., 0:1] + f_fd[..., h: h + 1] * sign[None, :]
    u = (u - base) * lo
    l_ = l_ * lo
    base = base * lo
    return base + torch.complex(2.0 * l_.real, 2.0 * u.imag)


def bank_demod(cfg, dstate, baseband: torch.Tensor):
    """Dispatch the demodulator of cfg.mode with cfg.demod_cfg (the
    Demodtab[] of modes.c:25-30), for a BankConfig or a ReceiverConfig."""
    if cfg.mode.demod == "FM":
        return fm_demod(cfg.demod_cfg, dstate, baseband)
    if cfg.mode.demod == "AM":
        return am_demod(cfg.demod_cfg, dstate, baseband)
    return linear_demod(cfg.demod_cfg, dstate, baseband)


def bank_step(
    cfg: BankConfig, state: BankState, iq_block: torch.Tensor
) -> tuple[BankState, torch.Tensor, dict]:
    """One wideband block through all channels.

    iq_block: (L,) complex64 at the wideband rate.  Returns
    (state, audio, diag); audio is (B, L_dec) float32.  Marks the stages
    ``ingest``, ``fft``, then group 0's (``utils.trace``)."""
    trace.mark("ingest", iq_block)
    samp = iq_block * state.gain_factor
    overlap, fdomain = master_execute(cfg.master, state.overlap, samp,
                                      stage="fft")
    state, audio, diag = _bank_step_spectrum(cfg, state, overlap, fdomain)
    trace.mark("pack", audio, group=0)
    return state, audio, diag


def _bank_step_spectrum(cfg: BankConfig, state: BankState,
                        overlap: torch.Tensor, fdomain, group: int = 0):
    """The bank step after the master FFT: recenter, channelize, demod, and
    the new state holding `overlap`; marks `group`'s stages."""
    trace.mark("channelize", state.k, group=group)
    state = bank_recenter(cfg, state)   # k-hops for swept channels
    return _bank_step_bins(cfg, state._replace(overlap=overlap),
                           _gather(cfg, state, fdomain), group)


def _bank_step_bins(cfg: BankConfig, state: BankState,
                    gathered: torch.Tensor, group: int = 0):
    """The bank step from a recentered state and its channels' gathered
    bins: channelize and demod (its stage marked for `group`).  Returns
    (new_state, audio, diag)."""
    new_r, new_nco, baseband = _channelize_bins(cfg, state, gathered)
    trace.mark("demod", baseband, group=group)
    dstate, audio, diag = bank_demod(cfg, state.demod, baseband)
    return state._replace(r=new_r, nco=new_nco, demod=dstate), audio, diag


def _pcm(audio: torch.Tensor) -> torch.Tensor:
    """scaleclip to int16 (audio.c:22-28); the cast truncates toward zero
    like the JAX package's astype."""
    return torch.clamp(audio * 32767.0, -32768.0, 32767.0).to(torch.int16)


def iq_from_i16(x_i16: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 I/Q -> (...) complex64 full scale, on x_i16's device
    (radio.c:38)."""
    x = x_i16.to(torch.float32) * (1.0 / 32767.0)
    return torch.complex(x[..., 0], x[..., 1])


def bank_step_i16(
    cfg: BankConfig, state: BankState, x_i16: torch.Tensor,
    pcm_out: bool = False,
) -> tuple[BankState, torch.Tensor, dict]:
    """bank_step on raw (L, 2) int16 I/Q (radio.c:38 scaling on the
    device, in the ``ingest`` stage).  pcm_out=True also quantises the
    audio to int16 PCM (in ``g0.pack``)."""
    trace.mark("ingest", x_i16)
    state, audio, diag = bank_step(cfg, state, iq_from_i16(x_i16))
    return state, (_pcm(audio) if pcm_out else audio), diag


def _top_active(peak: torch.Tensor, max_active: int,
                n_valid: int | None) -> torch.Tensor:
    """Indices of the max_active largest audio peaks; rows at or past
    n_valid (mesh padding) never compete."""
    if n_valid is not None and n_valid < peak.shape[0]:
        keep = torch.arange(peak.shape[0], device=peak.device) < n_valid
        peak = torch.where(keep, peak, torch.full_like(peak, -torch.inf))
    return torch.topk(peak, max_active).indices


def _active_pcm(sel: torch.Tensor, idx: torch.Tensor, n_valid: int | None):
    """The selected rows as int16 PCM and their indices, -1 where the row is
    silent (the all-zero-packet test of audio.c:54) or padding."""
    pcm = _pcm(sel)
    active = torch.amax(torch.abs(pcm), dim=-1) > 0
    if n_valid is not None:
        # padding rows still fill slots when max_active > n_valid
        active = active & (idx < n_valid)
    idx = torch.where(active, idx, torch.full_like(idx, -1))
    return pcm, idx.to(torch.int32)


def bank_step_active(
    cfg: BankConfig, state: BankState, x_i16: torch.Tensor, max_active: int,
    n_valid: int | None = None,
):
    """bank_step_i16 with device-side active-channel compaction (the
    reference's silence suppression, audio.c:102-113).

    Returns (state, pcm_i16 (max_active, L_dec) (stereo modes: (max_active,
    2*L_dec), each row its channel's (L_dec, 2) audio flattened),
    idx (max_active,) int32, diag): the top-max_active channels by audio
    peak as int16 PCM; idx[i] = -1 marks an unused slot (channel silent).
    n_valid: only the first n_valid channels compete for slots (mesh
    padding rows are excluded, parallel.mesh.pad_channels).  The
    compaction is part of the ``g0.pack`` stage."""
    state, audio, diag = bank_step_i16(cfg, state, x_i16)
    flat = audio.reshape(audio.shape[0], -1)
    idx = _top_active(torch.amax(torch.abs(flat), dim=-1), max_active,
                      n_valid)
    pcm, idx = _active_pcm(flat[idx], idx, n_valid)
    return state, pcm, idx, diag


def _set_ch(t: torch.Tensor, channel: int, val) -> torch.Tensor:
    """A copy of `t` with row `channel` set to `val` (a number or a tensor
    on t's device; nothing is fetched to the host)."""
    out = t.clone()
    out[channel] = val
    return out


def _cycles_per_sample(nco: OscState, channel: int) -> torch.Tensor:
    """The live NCO frequency of one channel in cycles/sample, float32, as
    the JAX package reads it (the word bitcast to int32, plus the
    residual)."""
    f = nco.freq[channel]
    fw = torch.where(f >= 2**31, f - 2**32, f)
    return fw.to(torch.float32) * float(np.float32(1.0 / _TWO32)) \
        + nco.freq_resid[channel]


def bank_tune(cfg: BankConfig, state: BankState, channel: int,
              freq_hz: float, old_freq_hz: float | None = None) -> BankState:
    """Retune one channel without phase discontinuity (osc.c:24-27): the
    residue r keeps its phase, only k, dr and the residual NCO frequency
    change, plus the group-delay phase correction for the delta change.

    The continuity terms come from the channel's LIVE k and NCO frequency
    (a Doppler sweep may have hopped k since the last command), read on the
    device with no host fetch.  `old_freq_hz` is accepted for the JAX
    package's signature and ignored.  The sweep rate is left as it is."""
    del old_freq_hz
    if not np.isfinite(freq_hz) or abs(freq_hz) > cfg.samprate / 2:
        raise ValueError(
            f"retune to {freq_hz!r} Hz outside the +-{cfg.samprate / 2:.0f} "
            f"Hz span of a {cfg.samprate:.0f} S/s bank")
    N = cfg.N
    nu = freq_hz / cfg.samprate
    k = int(np.round(nu * N))
    delta = nu - k / N
    hi, resid = split_double(-delta * cfg.decimate)
    km = k % N
    nco = state.nco
    # dcorr = (fq_old - fq_new) * (M-1) / (2 * decimate) cycles, mod 1
    fq_new = float(np.float32(-delta * cfg.decimate))
    dcorr = (_cycles_per_sample(nco, channel) - fq_new) * float(
        np.float32((cfg.master.M - 1) / 2.0 / cfg.decimate))
    dcorr = dcorr - torch.round(dcorr)
    new_nco = nco._replace(
        freq=_set_ch(nco.freq, channel, hi),
        freq_resid=_set_ch(nco.freq_resid, channel, float(np.float32(resid))),
        phase_resid=_set_ch(nco.phase_resid, channel,
                            nco.phase_resid[channel] + dcorr),
    )
    # r carries a -k*(M-1) alignment term (bank_init's r_0): switching k by
    # s needs r -= s*(M-1) mod N, or the block phase jumps (bank_recenter)
    s_k = km - state.k[channel].to(torch.int64)
    r_adj = (s_k % N) * ((cfg.master.M - 1) % N) % N
    r_ch = (state.r[channel].to(torch.int64) - r_adj) % N
    return state._replace(
        k=_set_ch(state.k, channel, km),
        dr=_set_ch(state.dr, channel, km * cfg.master.L % N),
        r=_set_ch(state.r, channel, r_ch.to(torch.int32)),
        nco=new_nco,
    )


def bank_set_doppler(cfg: BankConfig, state: BankState, channel: int,
                     base_freq_hz: float, doppler_hz: float = 0.0,
                     rate_hz_s: float = 0.0) -> BankState:
    """Doppler-steer one channel (radio.c:180-198, doppler.c:63-66): set
    its instantaneous frequency to base + doppler and its sweep rate,
    phase-continuously, without rewriting k (``bank_recenter`` hops k as
    the sweep drifts).

    The new residual frequency is relative to the channel's live k, the
    group-delay phase correction relative to its live NCO frequency, both
    read on the device.  The steer targets f(t - delay): the residual NCO
    runs after the filter's (M-1)/2-sample group delay."""
    doppler_hz = doppler_hz - rate_hz_s * (cfg.master.M - 1) / (
        2.0 * cfg.samprate)
    f_total = base_freq_hz + doppler_hz
    if not np.isfinite(f_total) or not np.isfinite(rate_hz_s) or \
            abs(f_total) > cfg.samprate / 2:
        raise ValueError(
            f"doppler steer to {f_total!r} Hz (rate {rate_hz_s!r} Hz/s) "
            f"outside the +-{cfg.samprate / 2:.0f} Hz span")
    N, N_dec = cfg.N, cfg.N_dec
    dsr = cfg.dsamprate
    # target position in master bins, split exactly on the host
    b = np.float64(f_total) / cfg.samprate * N
    b_int = int(np.round(b))
    b_frac = float(b - b_int)
    # signed wrapped distance from the channel's current k
    d = (b_int % N - state.k[channel].to(torch.int64)) % N
    d = torch.where(d > N // 2, d - N, d)
    excess = d.to(torch.float32) + float(np.float32(b_frac))  # bins above k
    fq_new = -excess * float(np.float32(1.0 / N_dec))  # cycles/dec-sample
    nco = state.nco
    dcorr = (_cycles_per_sample(nco, channel) - fq_new) * float(
        np.float32((cfg.master.M - 1) / 2.0 / cfg.decimate))
    dcorr = dcorr - torch.round(dcorr)
    rate_dec = -rate_hz_s / (dsr * dsr)        # cycles/dec-sample^2
    new_nco = nco._replace(
        freq=_set_ch(nco.freq, channel, 0),
        freq_resid=_set_ch(nco.freq_resid, channel, fq_new),
        rate=_set_ch(nco.rate, channel, float(np.float32(rate_dec))),
        phase_resid=_set_ch(nco.phase_resid, channel,
                            nco.phase_resid[channel] + dcorr),
    )
    return state._replace(nco=new_nco)


def _map_leaves(fn, live, fresh):
    """Apply fn to matching leaves of two state trees (NamedTuples, tuples,
    None)."""
    if live is None:
        return None
    if isinstance(live, tuple):
        out = [_map_leaves(fn, a, b) for a, b in zip(live, fresh)]
        return type(live)(*out) if hasattr(live, "_fields") else tuple(out)
    return fn(live, fresh)


def bank_reset_demod_row(state: BankState, fresh_demod, channel: int,
                         n_channels: int) -> BankState:
    """Reset ONE channel's demod state row to its freshly initialised value
    (the reference's demod-thread respawn on a mode or preset change,
    radio.c:322-374, as a state edit).

    `fresh_demod` is a ``bank_init`` demod subtree of the same structure.
    Leaves whose leading axis is the channel axis get row `channel` from
    it; shared leaves are left as they are."""

    def splice(live, tmpl):
        if live.ndim >= 1 and live.shape[0] == n_channels \
                and tmpl.shape == live.shape:
            return _set_ch(live, channel, tmpl[channel].to(live.device))
        return live

    return state._replace(demod=_map_leaves(splice, state.demod,
                                            fresh_demod))


def swap_filter_response(cfg: BankConfig, state: BankState,
                         low: float | None = None, high: float | None = None,
                         kaiser_beta: float | None = None):
    """Hot-swap the bank's shared frequency response (set_filter,
    filter.c:500-546): edges in Hz at the decimated rate.  The response is
    a state tensor, so the next block uses it.  Returns (cfg, state)."""
    mode = cfg.mode
    low = mode.low if low is None else low
    high = mode.high if high is None else high
    beta = cfg.kaiser_beta if kaiser_beta is None else kaiser_beta
    # np.i0 overflows for beta beyond ~226 and would NaN every channel's
    # shared response without raising; reference betas are 0..20
    if not np.isfinite(beta) or not 0.0 <= beta <= 100.0:
        raise ValueError(f"kaiser_beta out of range: {beta!r}")
    if not (np.isfinite(low) and np.isfinite(high)):
        raise ValueError(f"non-finite filter edges: {low!r}, {high!r}")
    slave = SlaveSpec(cfg.master, cfg.decimate, _out_type(mode))
    dsr = cfg.dsamprate
    resp = set_filter_response(slave, low / dsr, high / dsr, beta)
    demod_cfg = cfg.demod_cfg
    if mode.demod == "FM" and high != low and mode.high != mode.low:
        # fm.c recomputes the audio gain from the current edges every block
        # (fm.c:85-86): gain scales as 1/|high - low|
        demod_cfg = demod_cfg._replace(
            gain=float(demod_cfg.gain * abs(mode.high - mode.low)
                       / abs(high - low)))
    cfg = cfg._replace(mode=dc_replace(mode, low=low, high=high),
                       response=resp, kaiser_beta=beta, demod_cfg=demod_cfg)
    leaf = torch.as_tensor(resp, dtype=torch.complex64,
                           device=state.resp.device)
    return cfg, state._replace(resp=leaf)


def _swap_filter_shards(cfg: BankConfig, states, **edges):
    """swap_filter_response on a sharded state: the response is replicated,
    so every shard gets the same new one."""
    cfg, s0 = swap_filter_response(cfg, states[0], **edges)
    return cfg, tuple(s._replace(resp=s0.resp.to(s.resp.device))
                      for s in states)


def _edit_row(states, n_per_shard: int | None, channel: int, fn):
    """fn(state, row, shard) on the row of `channel`: on a sharded state
    (n_per_shard rows on each device) the shard that owns it is edited."""
    if n_per_shard is None:
        return fn(states, channel, 0)
    d, i = divmod(channel, n_per_shard)
    states = list(states)
    states[d] = fn(states[d], i, d)
    return tuple(states)


def _upload(x, dtype, device, graphs: StepGraphs | None = None
            ) -> torch.Tensor:
    """A host wrapper's input on its device (the entry's ``put``), stamped
    in the call's row and counted by path (``trace.uploaded``).  With
    `graphs` (a single-device wrapper's per-block entry), a host block in
    page-locked memory is copied on their copy stream while the card still
    runs the block before (``StepGraphs.upload``), and the card may read
    it after the entry has returned; any other input is a synchronous
    copy."""
    staged = None if graphs is None else graphs.upload(x, dtype)
    trace.uploaded(staged is not None)
    if staged is not None:
        return staged
    tok = trace.span("put", device, "upload")
    x = torch.as_tensor(x, dtype=dtype, device=device)
    trace.put_done(tok)
    return x


def _split(res):
    """(state, *outputs) -> (state, outputs), the StepGraphs step form."""
    return res[0], res[1:]


class ChannelBank:
    """Host wrapper: config + state + per-block calls, on one named device
    or sharded over a mesh.

    mesh: a ``parallel.mesh.ChannelMesh`` to shard the channel axis over
    (one logical bank spanning devices, the master/slave fan-out of
    filter.c:22-35 at multi-device scale); cfg.n_channels must be a
    multiple of its size (``parallel.mesh.pad_channels`` pads a frequency
    list), and the state is then a tuple of per-device BankStates.
    shard_fft also distributes the master FFT (``parallel.dfft``).  Without
    a mesh the caller names the device.

    Each per-block call is the JAX wrapper's jitted step: on a card, one
    captured CUDA graph per variant (``utils.graphs``; on a mesh one per
    shard, and with ``shard_fft`` a chain of three per shard joined by
    events on the devices), replayed once per call; ``process_scan_i16``
    replays one graph of k steps (on a mesh one per shard, with the master
    FFT replicated, as the JAX package's mesh scan is whatever
    ``shard_fft`` says; so is a mesh's ``process_active``).
    `capture=False`
    runs the same steps eagerly (the twin the graphs are held against).
    What a call returns belongs to the caller.  The live state is static:
    live edits write into it, ``state`` reads a copy of it (the same copy
    until the next block or edit) and assigning ``state`` writes into it.

    A per-block entry (every one but ``process_scan_i16``) of a bank on
    one device that captures takes a host block in page-locked memory
    without waiting for its copy, which runs on a copy stream while the
    card still runs the block before: the card may still be reading the
    block when the call returns.  The caller may rewrite that memory once
    an event recorded on the current stream after the call has completed
    (the outputs' copy to the host, say).  Any other input (pageable
    memory, a tensor on the card, a mesh, ``capture=False``, the CPU) is
    copied before the call returns."""

    def __init__(self, cfg: BankConfig, freqs_hz: Sequence[float], *,
                 device=None, mesh=None, shard_fft: bool = False,
                 capture: bool = True):
        if (device is None) == (mesh is None):
            raise ValueError("ChannelBank takes a device or a mesh")
        self.freqs = list(freqs_hz)
        self.mesh = mesh
        self.shard_fft = shard_fft
        self._snap = None
        if mesh is None:
            self.device = torch.device(device)
            self.cfg = cfg.to(self.device)
            self._state = static_copy(bank_init(cfg, freqs_hz,
                                                device=self.device))
            self._graphs = StepGraphs(self.device, capture)
            self._per_shard = None
        else:
            from ..parallel.mesh import ShardedBankStep, shard_bank_state

            self.device = mesh.devices[0]
            self.cfg = cfg
            self._sharded = ShardedBankStep(cfg, mesh, shard_fft, capture)
            self._per_shard = self._sharded.b
            # each shard its own tensors (shard_bank_state may hand out
            # views and one replicated tensor for every shard)
            self._state = tuple(static_copy(s) for s in shard_bank_state(
                mesh, bank_init(cfg, freqs_hz, device="cpu")))

    @property
    def state(self):
        """A copy of the state as of the last block or edit."""
        if self._snap is None:
            self._snap = clone_tree(self._state)
        return self._snap

    @property
    def graphs(self) -> list:
        """The compiled steps (one ``StepGraphs`` per device), for their
        replay and capture counts."""
        return [self._graphs] if self.mesh is None else self._sharded.graphs

    @state.setter
    def state(self, new) -> None:
        self._write(new)

    def _write(self, new) -> None:
        write_state(self._state, new)
        self._snap = None

    def _put(self, x, dtype) -> torch.Tensor:
        """A block on the device, from page-locked host memory without the
        host waiting (``_upload``)."""
        return _upload(x, dtype, self.device,
                       self._graphs if self.mesh is None else None)

    def _run(self, key, fn, x, warmup=None):
        """One call of the step variant `key` over the static state."""
        self._snap = None
        return self._graphs.run(key, fn, self._state, (x,), warmup)

    def _block(self, x, ingest: str, pcm_out: bool):
        if self.mesh is not None:
            self._snap = None
            return self._sharded.step(self._state, x, ingest, pcm_out)
        cfg = self.cfg
        if ingest == "i16":
            return self._run(("i16", pcm_out), lambda s, x: _split(
                bank_step_i16(cfg, s, x, pcm_out=pcm_out)), x)
        return self._run(("f32",), lambda s, x: _split(bank_step(cfg, s, x)),
                         x)

    @trace.entry("ChannelBank.process")
    def process(self, iq_block):
        """iq_block: (L,) complex or (L, 2) float packed I/Q (numpy or
        tensor).  Returns (audio, diag).  A page-locked host block may
        be read after the return (the class docstring)."""
        if iq_block.ndim == 2:
            x = _complex_block(self._put(iq_block, torch.float32))
        else:
            x = self._put(iq_block, torch.complex64)
        return self._block(x, "f32", False)

    @trace.entry("ChannelBank.process_i16")
    def process_i16(self, x_i16):
        """Raw (L, 2) int16 ingest.  Returns (audio, diag).  A page-locked
        host block may be read after the return (the class docstring)."""
        return self._block(self._put(x_i16, torch.int16), "i16", False)

    @trace.entry("ChannelBank.process_i16_pcm")
    def process_i16_pcm(self, x_i16):
        """int16 in, int16 PCM (B, L_dec) out.  Returns (pcm, diag).
        A page-locked host block may be read after the return (the class
        docstring)."""
        return self._block(self._put(x_i16, torch.int16), "i16", True)

    @trace.entry("ChannelBank.process_scan_i16")
    def process_scan_i16(self, x_i16_blocks, pcm_out: bool = False):
        """Demodulate (k, L, 2) int16 blocks in order, as one step of k
        blocks (the JAX ``bank_scan_packed_i16``; on a card one graph
        replay per call).  Returns audio (k, B, L_dec), int16 when
        pcm_out."""
        # k blocks: a synchronous copy, so no staging buffer k blocks wide
        blocks = _upload(x_i16_blocks, torch.int16, self.device)
        if self.mesh is not None:
            self._snap = None
            return self._sharded.scan(self._state, blocks, pcm_out)
        cfg = self.cfg

        def step(s, x):
            s, audio, _ = bank_step_i16(cfg, s, x, pcm_out=pcm_out)
            return s, audio

        return self._run(("scan", pcm_out),
                         lambda s, xs: scan(step, s, xs), blocks,
                         warmup=lambda s, xs: step(s, xs[0]))

    @trace.entry("ChannelBank.process_active")
    def process_active(self, x_i16, max_active: int = 64,
                       n_valid: int | None = None):
        """int16 in; int16 PCM of the top-max_active non-silent channels
        out, plus their channel indices (-1 = unused slot).  n_valid keeps
        mesh-padding rows out of the compaction.  A page-locked host block
        may be read after the return (the class docstring)."""
        x = self._put(x_i16, torch.int16)
        if self.mesh is not None:
            self._snap = None
            return self._sharded.active(self._state, x, max_active, n_valid)
        cfg = self.cfg
        return self._run(("active", max_active, n_valid),
                         lambda s, x: _split(bank_step_active(
                             cfg, s, x, max_active, n_valid)), x)

    def tune(self, channel: int, freq_hz: float) -> None:
        """Retune one channel without phase discontinuity (radio.c:204-242
        set_freq at bank scale; see bank_tune)."""
        # device state first: if it rejects the frequency, the host list
        # must not desync from it
        self._write(_edit_row(
            self._state, self._per_shard, channel,
            lambda s, i, _: bank_tune(self.cfg, s, i, freq_hz)))
        self.freqs[channel] = freq_hz

    def set_filter(self, low: float | None = None, high: float | None = None,
                   kaiser_beta: float | None = None) -> None:
        """Hot-swap the bank's shared frequency response
        (swap_filter_response).  The response is static state; the steps
        are captured again only where the FM audio gain changed with it."""
        edges = dict(low=low, high=high, kaiser_beta=kaiser_beta)
        if self.mesh is None:
            cfg, state = swap_filter_response(self.cfg, self._state, **edges)
            if cfg.demod_cfg is not self.cfg.demod_cfg:
                self._graphs.clear()
            self.cfg = cfg
            self._write(state)
            return
        cfg, states = _swap_filter_shards(self.cfg, self._state, **edges)
        self._sharded.set_config(cfg)
        self.cfg = cfg
        self._write(states)

    def set_doppler(self, channel: int, doppler_hz: float,
                    rate_hz_s: float) -> None:
        """Doppler-steer one channel (set_doppler, radio.c:180-198): offset
        and sweep rate on top of its base frequency (self.freqs, which
        retunes keep current)."""
        self._write(_edit_row(
            self._state, self._per_shard, channel,
            lambda s, i, _: bank_set_doppler(
                self.cfg, s, i, self.freqs[channel], doppler_hz=doppler_hz,
                rate_hz_s=rate_hz_s)))

    def steer_adapter(self, channel: int):
        """A per-channel facade with the Receiver steering interface
        (.tune_freq / .set_doppler), so a Doppler steerer can drive one
        bank channel like a reference `radio -d` instance."""
        bank = self

        class _Chan:
            @property
            def tune_freq(self):
                return bank.freqs[channel]

            def set_doppler(self, f, r):
                bank.set_doppler(channel, f, r)

        return _Chan()


def _complex_block(x: torch.Tensor) -> torch.Tensor:
    """(L,) complex, or (L, 2) real packed I/Q, as (L,) complex64."""
    if x.ndim == 2:
        x = x.to(torch.float32)
        return torch.complex(x[..., 0], x[..., 1])
    return x.to(torch.complex64)


def multibank_step(cfgs: Sequence[BankConfig], states: Sequence[BankState],
                   iq_block: torch.Tensor):
    """One wideband block through every group of a mixed-mode bank: ONE
    master FFT, then each group's recenter, channelize and demod.

    iq_block: (L,) complex64.  Returns (states, [(audio, diag), ...]); every
    new state holds the same new overlap tensor.  Marks the stages
    ``ingest``, ``fft`` and each group's channelize and demod
    (``utils.trace``; the caller marks where each group's pack starts)."""
    trace.mark("ingest", iq_block)
    overlap, fdomain = master_execute(cfgs[0].master, states[0].overlap,
                                      iq_block, stage="fft")
    new_states, outs = [], []
    for g, (cfg, s) in enumerate(zip(cfgs, states)):
        ns, audio, diag = _bank_step_spectrum(cfg, s, overlap, fdomain, g)
        new_states.append(ns)
        outs.append((audio, diag))
    return new_states, outs


class MultiBank:
    """Mixed-mode channel bank: several demod groups sharing ONE wideband
    forward FFT (the master/slave idea of filter.c:22-35 at scale).  Each
    group (mode, [freqs]) has its own config, state and batched demod.

    groups: list of (mode_name, [freq_hz, ...]).  Extra keywords go to
    make_bank_config.  On one named device, or with `mesh` every group's
    channel axis sharded over it: each group is padded to a multiple of
    the mesh size (``group_real[g]`` rows of group g's audio are real, the
    rest padding), the wideband block and master FFT replicated.

    Each block is one step of every group (``multibank_step``): on a card
    one captured CUDA graph per variant (on a mesh one per device), as
    ``ChannelBank``; `capture=False` runs it eagerly.  ``states`` reads a
    copy of the static state and assigning it writes into it.  On one
    device that captures, a host block in page-locked memory may still be
    read by the card after an entry returns, as ``ChannelBank``'s
    per-block entries: the caller may rewrite it once an event recorded on
    the current stream after the call has completed."""

    def __init__(self, groups: Sequence[tuple[str, Sequence[float]]],
                 samprate: float = 24.576e6, L: int = 491520,
                 M: int = 557057, *, device=None, mesh=None,
                 capture: bool = True, **kw):
        if (device is None) == (mesh is None):
            raise ValueError("MultiBank takes a device or a mesh")
        self.mesh = mesh
        self._snap = None
        self.group_real = [len(freqs) for _, freqs in groups]
        if mesh is not None:
            from ..parallel.mesh import pad_channels

            groups = [(mode, pad_channels(freqs, mesh.size))
                      for mode, freqs in groups]
        self.group_freqs = [list(freqs) for _, freqs in groups]
        cfgs = [make_bank_config(len(freqs), mode, samprate=samprate, L=L,
                                 M=M, **kw) for mode, freqs in groups]
        master = cfgs[0].master
        for c in cfgs[1:]:
            # a real error, not an assert: a group channelizing a spectrum
            # of another FFT geometry would give garbled audio silently
            if c.master != master:
                raise ValueError(
                    f"MultiBank groups must share one master: "
                    f"{c.master} != {master}")
        if mesh is None:
            self.device = torch.device(device)
            self.cfgs = [c.to(self.device) for c in cfgs]
            states = [static_copy(bank_init(c, freqs, device=self.device))
                      for c, freqs in zip(cfgs, self.group_freqs)]
            self._states = [s._replace(overlap=states[0].overlap)
                            for s in states]
            self._per_shard = [None] * len(cfgs)
            self._graphs = [StepGraphs(self.device, capture)]
        else:
            from ..parallel.mesh import shard_bank_state

            self.device = mesh.devices[0]
            self.cfgs = cfgs
            self._per_shard = [c.n_channels // mesh.size for c in cfgs]
            self._build_shard_cfgs()
            shards = [shard_bank_state(mesh, bank_init(c, f, device="cpu"))
                      for c, f in zip(cfgs, self.group_freqs)]
            # each device its own tensors, and one overlap per device
            # shared by every group
            per_dev = [[static_copy(st[d]) for st in shards]
                       for d in range(mesh.size)]
            per_dev = [[s._replace(overlap=ss[0].overlap) for s in ss]
                       for ss in per_dev]
            self._states = [tuple(ss[g] for ss in per_dev)
                            for g in range(len(cfgs))]
            self._graphs = [StepGraphs(dev, capture) for dev in mesh.devices]
        # each group's freshly initialised demod subtree (per shard on a
        # mesh), for init_channel's per-row respawn: a copy, since the
        # state itself is written in place every block
        self._fresh_demod = [
            static_copy(s.demod) if mesh is None
            else [static_copy(sh.demod) for sh in s] for s in self._states]

    @property
    def states(self) -> list:
        """A copy of every group's state as of the last block or edit."""
        if self._snap is None:
            self._snap = clone_tree(self._states)
        return self._snap

    @states.setter
    def states(self, new) -> None:
        write_state(self._states, list(new))
        self._snap = None

    @property
    def graphs(self) -> list:
        """The compiled steps (one ``StepGraphs`` per device)."""
        return self._graphs

    def _build_shard_cfgs(self) -> None:
        from ..parallel.mesh import shard_configs

        self._shard_cfgs = [shard_configs(c, self.mesh) for c in self.cfgs]

    def _put(self, x, dtype) -> torch.Tensor:
        """The block on the device, from page-locked host memory without
        the host waiting (``_upload``)."""
        return _upload(x, dtype, self.device,
                       self._graphs[0] if self.mesh is None else None)

    def _step(self, x: torch.Tensor, ingest: str, pcm_out: bool) -> list:
        """One block of every group: the raw input `x` (ingest "f32": (L,)
        complex or (L, 2) float I/Q; "i16": (L, 2) int16) through one
        master FFT and each group's step, as the variant (ingest,
        pcm_out)."""
        self._snap = None

        def step(cfgs):
            def fn(states, x):
                trace.mark("ingest", x)
                blk = iq_from_i16(x) if ingest == "i16" else _complex_block(x)
                new, outs = multibank_step(cfgs, states, blk)
                packed = []
                for g, (a, d) in enumerate(outs):
                    trace.mark("pack", a, group=g)
                    packed.append((_pcm(a) if pcm_out else a, d))
                return new, packed
            return fn

        key = (ingest, pcm_out)
        if self.mesh is None:
            return self._graphs[0].run(key, step(self.cfgs), self._states,
                                       (x,))
        from ..parallel.mesh import gather_shards

        # the block on every device before any step is queued (as
        # ShardedBankStep._run)
        xs = [x.to(dev) for dev in self.mesh.devices]
        per = [g.run(key, step([c[d] for c in self._shard_cfgs]),
                     [st[d] for st in self._states], (xs[d],))
               for d, g in enumerate(self._graphs)]
        outs = []
        for g in range(len(self._states)):
            shards = [p[g] for p in per]
            outs.append((
                gather_shards([a for a, _ in shards], self.device),
                {k: gather_shards([dg[k] for _, dg in shards], self.device)
                 for k in shards[0][1]}))
        return outs

    @trace.entry("MultiBank.process")
    def process(self, iq_block) -> list:
        """iq_block: (L,) complex or (L, 2) float packed I/Q (numpy or
        tensor).  Returns [(audio, diag), ...] per group.  A page-locked
        host block may be read after the return (the class docstring)."""
        return self._step(self._put(iq_block, None), "f32", False)

    @trace.entry("MultiBank.process_i16")
    def process_i16(self, x_i16) -> list:
        """Raw (L, 2) int16 ingest, scaled on the device (radio.c:38).
        Returns [(audio, diag), ...] per group.  A page-locked host block
        may be read after the return (the class docstring)."""
        return self._step(self._put(x_i16, torch.int16), "i16", False)

    @trace.entry("MultiBank.process_i16_pcm")
    def process_i16_pcm(self, x_i16) -> list:
        """int16 in, int16 PCM out.  Returns [(pcm, diag), ...] per group.
        A page-locked host block may be read after the return (the class
        docstring)."""
        return self._step(self._put(x_i16, torch.int16), "i16", True)

    def _edit(self, group: int, idx: int, fn) -> None:
        write_state(self._states[group], _edit_row(
            self._states[group], self._per_shard[group], idx, fn))
        self._snap = None

    def tune(self, group: int, idx: int, freq_hz: float) -> None:
        """Retune one channel of one group, phase-continuously
        (ChannelBank.tune)."""
        # device state first, host list second (see ChannelBank.tune)
        self._edit(group, idx, lambda s, i, _: bank_tune(
            self.cfgs[group], s, i, freq_hz))
        self.group_freqs[group][idx] = freq_hz

    def set_doppler(self, group: int, idx: int, doppler_hz: float,
                    rate_hz_s: float) -> None:
        """Doppler-steer one channel of one group (ChannelBank.set_doppler)."""
        self._edit(group, idx, lambda s, i, _: bank_set_doppler(
            self.cfgs[group], s, i, self.group_freqs[group][idx],
            doppler_hz=doppler_hz, rate_hz_s=rate_hz_s))

    def init_channel(self, group: int, idx: int, freq_hz: float) -> None:
        """(Re)commission one slot of one group: fresh demod state for the
        row (the reference's respawned demod thread on a mode change,
        radio.c:322-374), a phase-continuous retune, and a cleared Doppler
        sweep.  State edits only: the steps keep their graphs."""
        fresh = self._fresh_demod[group]
        n = self._per_shard[group] or len(self.group_freqs[group])
        self._edit(group, idx, lambda s, i, d: bank_reset_demod_row(
            s, fresh if self.mesh is None else fresh[d], i, n))
        self.tune(group, idx, freq_hz)
        self.set_doppler(group, idx, 0.0, 0.0)

    def set_filter(self, group: int, low: float | None = None,
                   high: float | None = None,
                   kaiser_beta: float | None = None) -> None:
        """Hot-swap ONE group's shared frequency response; the other
        groups' responses are untouched (swap_filter_response).  The step
        is captured again only where the FM audio gain changed."""
        edges = dict(low=low, high=high, kaiser_beta=kaiser_beta)
        old = self.cfgs[group]
        if self.mesh is None:
            cfg, state = swap_filter_response(old, self._states[group],
                                              **edges)
        else:
            cfg, state = _swap_filter_shards(old, self._states[group],
                                             **edges)
        self.cfgs[group] = cfg
        write_state(self._states[group], state)
        self._snap = None
        if self.mesh is not None:
            self._build_shard_cfgs()
        if cfg.demod_cfg is not old.demod_cfg:
            for g in self._graphs:
                g.clear()


def make_bank(n_channels: int, mode: str = "FM",
              freqs_hz: Sequence[float] | None = None, *, device,
              **kw) -> ChannelBank:
    """A ChannelBank; by default the channels spread over the usable 90% of
    the band (the outer 5% on each side left out)."""
    cfg = make_bank_config(n_channels, mode, **kw)
    if freqs_hz is None:
        usable = 0.9 * cfg.samprate
        freqs_hz = list(np.linspace(-usable / 2, usable / 2, n_channels,
                                    endpoint=False))
    return ChannelBank(cfg, freqs_hz, device=device)
