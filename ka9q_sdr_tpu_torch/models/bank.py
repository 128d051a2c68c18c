"""Wideband multichannel bank on torch tensors: the FM(+PL) path.

Port of ``ka9q_sdr_tpu.models.bank``: ONE wideband forward FFT per block,
then for every channel a bin gather (frequency conversion done in the
frequency domain), the shared frequency response, the exact integer block
phase, a batched short IFFT, a residual fine-tune NCO at the decimated rate,
and the batched FM demodulator.  See the JAX module's docstring for the
frequency-conversion algebra; the port computes the same math.

What differs from the JAX package, by design:

- The per-channel window gather is the plain one, ``fdomain[(base_idx + k)
  % N]``.  The JAX package's aligned 128-bin chunk-row gather with its
  shifted-response table exists because the TPU has no fast dynamic gather.
- Block-phase residues are computed in int64, where ``(s * c) % N`` is exact;
  the JAX package's int32 limb arithmetic (``_mul_mod_n``) only avoided
  int32 overflow.
- State keeps complex tensors: there is no real-dtype packing boundary.
- Only the FM demodulator is ported so far; other modes raise.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ka9q_sdr_tpu.utils.modes import DEFAULT_MODES, ModeDef

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_execute,
    set_filter_response,
    slave_bin_indices,
)
from ..ops.nco import OscState, osc_block, osc_init, set_osc, split_double
from .demod_fm import FMConfig, fm_demod, fm_init

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
    demod_cfg: FMConfig
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
    demod: object           # batched demod state (FMState)
    gain_factor: torch.Tensor  # float32 scalar


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
    if mode.demod != "FM":
        raise NotImplementedError(
            f"{mode.name}: only FM banks are ported so far; AM is ROADMAP "
            "§1 item 11, linear/CAM/ISB item 12"
        )
    master = MasterSpec(L, M, FilterType.COMPLEX)
    N = master.N
    # Channel geometry mirrors the reference receiver: 48 kHz output.
    decimate = round(samprate / 48000.0)
    if N % decimate:
        raise ValueError(f"N={N} not divisible by decimate={decimate}")
    slave = SlaveSpec(master, decimate, FilterType.COMPLEX)
    dsamprate = samprate / decimate
    response = set_filter_response(
        slave, mode.low / dsamprate, mode.high / dsamprate, kaiser_beta
    )
    base_idx = slave_bin_indices(slave).astype(np.int32)
    L_dec = L // decimate
    M_dec = (M - 1) // decimate + 1
    demod_cfg = FMConfig.make(
        dsamprate, mode.low, mode.high, L_dec, M_dec,
        headroom_db=headroom_db, kaiser_beta=kaiser_beta,
        flat=mode.flat, enable_pl=enable_pl and not mode.flat,
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

    return BankState(
        overlap=torch.zeros((cfg.master.M - 1,), dtype=torch.complex64,
                            device=device),
        resp=torch.as_tensor(cfg.response, dtype=torch.complex64,
                             device=device),
        k=i32(ks64),
        r=i32(r0),
        dr=i32(dr0),
        nco=nco,
        demod=fm_init(cfg.demod_cfg, (B,), device=device),
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
    cfg: BankConfig, state: BankState, fdomain: torch.Tensor
) -> tuple[torch.Tensor, OscState, torch.Tensor]:
    """Shared-FFT channel extraction: gather + response + block phase +
    batched IFFT + residual NCO.  Returns (new_r, new_nco, baseband) with
    baseband (B, L_dec) complex64."""
    N, N_dec, L_dec = cfg.N, cfg.N_dec, cfg.L_dec
    # the JAX package's expression: f32 residue, complex64 exponent
    phi = torch.exp((-2j * np.pi / N) * state.r.to(torch.float32))
    new_r = (state.r + state.dr) % N
    new_nco, lo = osc_block(state.nco, L_dec)
    base = torch.as_tensor(cfg.base_idx, dtype=torch.int64,
                           device=fdomain.device)
    idx = (base[None, :] + state.k[:, None]) % N
    f_fd = fdomain[idx] * state.resp[None, :] * phi[:, None]
    y = torch.fft.ifft(f_fd, dim=-1) * N_dec
    return new_r, new_nco, y[..., N_dec - L_dec:] * lo


def bank_demod(cfg: BankConfig, dstate, baseband: torch.Tensor):
    """The batched demodulator for this bank's mode (FM only so far)."""
    return fm_demod(cfg.demod_cfg, dstate, baseband)


def bank_step(
    cfg: BankConfig, state: BankState, iq_block: torch.Tensor
) -> tuple[BankState, torch.Tensor, dict]:
    """One wideband block through all channels.

    iq_block: (L,) complex64 at the wideband rate.  Returns
    (state, audio, diag); audio is (B, L_dec) float32."""
    samp = iq_block * state.gain_factor
    overlap, fdomain = master_execute(cfg.master, state.overlap, samp)
    state = bank_recenter(cfg, state)   # k-hops for swept channels
    new_r, new_nco, baseband = bank_channelize(cfg, state, fdomain)
    dstate, audio, diag = bank_demod(cfg, state.demod, baseband)
    new_state = state._replace(overlap=overlap, r=new_r, nco=new_nco,
                               demod=dstate)
    return new_state, audio, diag


def _pcm(audio: torch.Tensor) -> torch.Tensor:
    """scaleclip to int16 (audio.c:22-28); the cast truncates toward zero
    like the JAX package's astype."""
    return torch.clamp(audio * 32767.0, -32768.0, 32767.0).to(torch.int16)


def bank_step_i16(
    cfg: BankConfig, state: BankState, x_i16: torch.Tensor,
    pcm_out: bool = False,
) -> tuple[BankState, torch.Tensor, dict]:
    """bank_step on raw (L, 2) int16 I/Q (radio.c:38 scaling on the
    device).  pcm_out=True also quantises the audio to int16 PCM."""
    x = x_i16.to(torch.float32) * (1.0 / 32767.0)
    state, audio, diag = bank_step(cfg, state,
                                   torch.complex(x[..., 0], x[..., 1]))
    return state, (_pcm(audio) if pcm_out else audio), diag


def bank_step_active(
    cfg: BankConfig, state: BankState, x_i16: torch.Tensor, max_active: int
):
    """bank_step_i16 with device-side active-channel compaction (the
    reference's silence suppression, audio.c:102-113).

    Returns (state, pcm_i16 (max_active, L_dec), idx (max_active,) int32,
    diag): the top-max_active channels by audio peak as int16 PCM;
    idx[i] = -1 marks an unused slot (channel silent)."""
    state, audio, diag = bank_step_i16(cfg, state, x_i16)
    flat = audio.reshape(audio.shape[0], -1)
    peak = torch.amax(torch.abs(flat), dim=-1)
    _, idx = torch.topk(peak, max_active)
    pcm = _pcm(flat[idx])
    # all-zero int16 audio is inactive: the all-zero-packet test of audio.c:54
    active = torch.amax(torch.abs(pcm), dim=-1) > 0
    idx = torch.where(active, idx, torch.full_like(idx, -1))
    return state, pcm, idx.to(torch.int32), diag


class ChannelBank:
    """Host wrapper: config + state on one named device + per-block calls."""

    def __init__(self, cfg: BankConfig, freqs_hz: Sequence[float], *,
                 device):
        self.device = torch.device(device)
        self.cfg = cfg.to(self.device)
        self.freqs = list(freqs_hz)
        self.state = bank_init(cfg, freqs_hz, device=self.device)

    def _put(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def process(self, iq_block):
        """iq_block: (L,) complex (numpy or tensor).  Returns (audio, diag)."""
        self.state, audio, diag = bank_step(
            self.cfg, self.state, self._put(iq_block, torch.complex64))
        return audio, diag

    def process_i16(self, x_i16):
        """Raw (L, 2) int16 ingest.  Returns (audio, diag)."""
        self.state, audio, diag = bank_step_i16(
            self.cfg, self.state, self._put(x_i16, torch.int16))
        return audio, diag

    def process_i16_pcm(self, x_i16):
        """int16 in, int16 PCM (B, L_dec) out.  Returns (pcm, diag)."""
        self.state, pcm, diag = bank_step_i16(
            self.cfg, self.state, self._put(x_i16, torch.int16), pcm_out=True)
        return pcm, diag

    def process_scan_i16(self, x_i16_blocks, pcm_out: bool = False):
        """Demodulate (k, L, 2) int16 blocks in order.  Returns audio
        (k, B, L_dec), int16 when pcm_out."""
        blocks = self._put(x_i16_blocks, torch.int16)
        outs = []
        for x in blocks:
            self.state, audio, _ = bank_step_i16(self.cfg, self.state, x,
                                                 pcm_out=pcm_out)
            outs.append(audio)
        return torch.stack(outs)

    def process_active(self, x_i16, max_active: int = 64):
        """int16 in; int16 PCM of the top-max_active non-silent channels
        out, plus their channel indices (-1 = unused slot)."""
        self.state, pcm, idx, diag = bank_step_active(
            self.cfg, self.state, self._put(x_i16, torch.int16), max_active)
        return pcm, idx, diag
