"""Single-channel receiver on torch tensors: the `radio` program's sample
path (radio.c proc_samples + one demod thread).

Port of ``ka9q_sdr_tpu.models.receiver``.  One block goes through front-end
gain, the second LO and Doppler mix, the overlap-save master FFT, the noise
estimate, the slave filter and the demodulator of the mode, as one block
function over explicit state; ``Receiver`` wraps it with the control plane
of radio.c:200-316 (tuning, live filter and shift edits, option, mode and
blocksize rebuilds).

What differs from the JAX package, by design:

- No jit and no real-dtype packing boundary: state keeps complex tensors,
  and the filter response and passband mask are device tensors that a live
  ``set_filter`` replaces.
- ``receiver_scan`` is a loop over blocks (the JAX package's ``lax.scan``).
- ``receiver_step`` also runs batched over leading axes (``receiver_init(cfg,
  (B,))``); the JAX function needs ``jax.vmap`` for that, because its
  ``compute_n0`` does not broadcast.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_execute,
    set_filter_response,
    slave_execute,
)
from ..ops.nco import OscState, osc_block, osc_init, set_osc
from ..utils.modes import DEFAULT_MODES, ModeDef
from .bank import bank_demod, iq_from_i16
from .demod_am import AMConfig, am_init
from .demod_fm import FMConfig, fm_init
from .demod_linear import LinearConfig, linear_init
from .noise import compute_n0, passband_mask

__all__ = [
    "ReceiverConfig",
    "ReceiverState",
    "Receiver",
    "SDRStatus",
    "make_receiver",
    "make_receiver_config",
    "receiver_init",
    "receiver_step",
    "receiver_scan",
    "mix_second_lo",
    "psd128",
    "scale_iq",
]

#: SDR alias keep-out margin (radio.c:28).
IF_EXCLUDE = 0.95
#: int16 / int8 sample scaling (radio.c:38-39).
SCALE16 = 1.0 / 32767.0
SCALE8 = 1.0 / 127.0
#: Default filter dimensions (main.c:113-115): L=3840, M=4353, N=8192.
DEFAULT_L = 3840
DEFAULT_M = 4353


class ReceiverConfig(NamedTuple):
    """Static receiver configuration (see the JAX package's
    ReceiverConfig).  `response` and `n0_mask` are host arrays as designed;
    `to(device)` places the demodulator's constants on a device."""

    samprate: int           # input sample rate, Hz
    decimate: int           # samprate / output rate (radio_status.c:264-267)
    mode: ModeDef
    master: MasterSpec
    slave: SlaveSpec
    response: np.ndarray    # slave frequency response
    n0_mask: np.ndarray     # passband mask for compute_n0
    n0_alpha: float         # n0 smoothing (fm.c:82 = .01, am/linear = .001)
    demod_cfg: object       # FMConfig | AMConfig | LinearConfig
    kaiser_beta: float = 3.0     # current window beta (display.c 'k')
    headroom_db: float = -15.0   # AGC headroom (modes.c)
    enable_pl: bool = True       # FM PL tone chain

    @property
    def dsamprate(self) -> float:
        return self.samprate / self.decimate

    @property
    def L(self) -> int:
        return self.master.L

    @property
    def blocktime(self) -> float:
        return self.master.L / self.samprate

    def to(self, device) -> "ReceiverConfig":
        """This config with the demodulator's responses as tensors on
        `device`, so a block uploads nothing."""
        return self._replace(demod_cfg=self.demod_cfg.to(device))


class ReceiverState(NamedTuple):
    overlap: torch.Tensor      # master filter overlap
    lo2: OscState              # second (software) LO
    doppler: OscState          # Doppler sweep oscillator
    demod: object              # FMState | AMState | LinearState
    n0: torch.Tensor           # float32, smoothed noise density
    if_power: torch.Tensor     # float32
    gain_factor: torch.Tensor  # float32, front-end analog gain compensation


def make_receiver_config(
    mode: str | ModeDef,
    samprate: int = 192000,
    out_rate: int = 48000,
    L: int = DEFAULT_L,
    M: int = DEFAULT_M,
    kaiser_beta: float = 3.0,
    headroom_db: float = -15.0,
    enable_pl: bool = True,
) -> ReceiverConfig:
    """Build a config the way main.c + set_mode do at startup (a copy of
    the JAX package's host math)."""
    if isinstance(mode, str):
        mode = DEFAULT_MODES[mode.upper()]
    if samprate % out_rate:
        raise ValueError(f"samprate {samprate} not divisible by {out_rate}")
    decimate = int(samprate // out_rate)
    master = MasterSpec(L, M, FilterType.COMPLEX)
    dsamprate = samprate / decimate
    if mode.demod == "LINEAR" and mode.isb:
        out_type = FilterType.CROSS_CONJ
    else:
        out_type = FilterType.COMPLEX
    slave = SlaveSpec(master, decimate, out_type)
    # set_filter edges in cycles/sample of the decimated rate
    # (fm.c:35, am.c:41, linear.c:81)
    response = set_filter_response(
        slave, mode.low / dsamprate, mode.high / dsamprate, kaiser_beta)
    mask = passband_mask(master.N, samprate, mode.low, mode.high)
    L_dec = L // decimate
    M_dec = (M - 1) // decimate + 1
    if mode.demod == "FM":
        demod_cfg = FMConfig.make(
            dsamprate, mode.low, mode.high, L_dec, M_dec,
            headroom_db=headroom_db, kaiser_beta=kaiser_beta,
            flat=mode.flat, enable_pl=enable_pl and not mode.flat,
        )
        n0_alpha = 0.01
    elif mode.demod == "AM":
        demod_cfg = AMConfig.make(
            dsamprate, headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate, hangtime_s=mode.hangtime,
        )
        n0_alpha = 0.001
    else:
        demod_cfg = LinearConfig.make(
            dsamprate, L_dec, headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate, hangtime_s=mode.hangtime,
            pll=mode.pll, square=mode.square, channels=mode.channels,
            shift_freq=mode.shift / dsamprate,  # set_shift, radio.c:304-311
        )
        n0_alpha = 0.001
    return ReceiverConfig(
        samprate=samprate,
        decimate=decimate,
        mode=mode,
        master=master,
        slave=slave,
        response=response,
        n0_mask=mask,
        n0_alpha=n0_alpha,
        demod_cfg=demod_cfg,
        kaiser_beta=kaiser_beta,
        headroom_db=headroom_db,
        enable_pl=enable_pl,
    )


def receiver_init(cfg: ReceiverConfig, batch_shape=(), *,
                  device) -> ReceiverState:
    shape = tuple(batch_shape)
    if cfg.mode.demod == "FM":
        dstate = fm_init(cfg.demod_cfg, shape, device=device)
    elif cfg.mode.demod == "AM":
        dstate = am_init(shape, device=device)
    else:
        dstate = linear_init(cfg.demod_cfg, shape, device=device)
    osc = osc_init(shape, device=device)
    return ReceiverState(
        overlap=torch.zeros(shape + (cfg.master.M - 1,),
                            dtype=torch.complex64, device=device),
        lo2=osc,
        doppler=osc,
        demod=dstate,
        n0=torch.full(shape, float("nan"), dtype=torch.float32,
                      device=device),
        if_power=torch.zeros(shape, dtype=torch.float32, device=device),
        gain_factor=torch.ones(shape, dtype=torch.float32, device=device),
    )


def mix_second_lo(state: ReceiverState, samp: torch.Tensor, L: int):
    """The second LO and the Doppler NCO ramps over one L-sample block,
    mixed into `samp` (radio.c:131-136; both keep phase through gaps).
    Returns (lo2, doppler, mixed)."""
    lo2, lo = osc_block(state.lo2, L)
    doppler, dlo = osc_block(state.doppler, L)
    return lo2, doppler, samp * lo * dlo


def psd128(fdomain: torch.Tensor) -> torch.Tensor:
    """128-bin peak-held power spectrum of the master FFT, ordered
    -fs/2..+fs/2, for the display's spectrum pane."""
    ps = torch.fft.fftshift(fdomain.real ** 2 + fdomain.imag ** 2, dim=-1)
    nb = 128
    trim = (ps.shape[-1] // nb) * nb
    return torch.amax(ps[..., :trim].reshape(ps.shape[:-1] + (nb, -1)),
                      dim=-1)


def receiver_step(
    cfg: ReceiverConfig,
    state: ReceiverState,
    iq_block: torch.Tensor,
    response: torch.Tensor | None = None,
    n0_mask: torch.Tensor | None = None,
) -> tuple[ReceiverState, torch.Tensor, dict]:
    """One L-sample block through the full receiver (radio.c:106-147 + the
    demod thread body).

    iq_block: (..., L) complex64 at the input rate, scaled to +/-1.0 full
    scale.  `response` / `n0_mask` override the config's filter response
    and passband mask with device tensors (a live set_filter swaps them)."""
    dev = iq_block.device
    samp = iq_block * state.gain_factor[..., None]
    # block_energy * 0.5 / in_cnt (two components per sample, radio.c:143-144)
    if_power = 0.5 * torch.mean(samp.real ** 2 + samp.imag ** 2, dim=-1)

    lo2, doppler, samp = mix_second_lo(state, samp, cfg.L)

    overlap, fdomain = master_execute(cfg.master, state.overlap, samp)

    if n0_mask is None:
        n0_mask = torch.as_tensor(cfg.n0_mask, device=dev)
    n0_raw = compute_n0(fdomain, n0_mask, cfg.samprate)
    n0 = torch.where(torch.isnan(state.n0), n0_raw,
                     state.n0 + cfg.n0_alpha * (n0_raw - state.n0))

    if response is None:
        response = torch.as_tensor(cfg.response, device=dev)
    baseband = slave_execute(cfg.slave, fdomain, response)
    dstate, audio, diag = bank_demod(cfg, state.demod, baseband)

    diag = dict(diag)
    diag["n0"] = n0
    diag["if_power"] = if_power
    diag["psd128"] = psd128(fdomain)

    new_state = ReceiverState(
        overlap=overlap,
        lo2=lo2,
        doppler=doppler,
        demod=dstate,
        n0=n0,
        if_power=if_power,
        gain_factor=state.gain_factor,
    )
    return new_state, audio, diag


def receiver_scan(cfg: ReceiverConfig, state: ReceiverState, blocks,
                  response: torch.Tensor | None = None,
                  n0_mask: torch.Tensor | None = None):
    """Offline batch path: the receiver over many blocks in order (the
    JAX package's lax.scan, as a loop; replaying a recording through
    `radio` faster than real time).

    blocks: (nblocks, L) complex.  Returns (final_state, audio) with audio
    stacked (nblocks, ...).  Diagnostics are dropped."""
    outs = []
    for blk in blocks:
        state, audio, _ = receiver_step(cfg, state, blk, response, n0_mask)
        outs.append(audio)
    return state, torch.stack(outs)


def scale_iq(raw: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """int16/int8 interleaved I/Q -> complex64 full scale (radio.c:106-120).
    raw: (..., 2n) int tensor, I/Q interleaved."""
    scale = SCALE16 if bits == 16 else SCALE8
    x = raw.to(torch.float32) * scale
    return torch.complex(x[..., 0::2], x[..., 1::2])


@dataclass
class SDRStatus:
    """Mirror of the front end's TLV status (struct sdr, radio.h), as used
    by the tuning math (radio.c:200-284).  Until the front end reports its
    alias keep-out, default to IF_EXCLUDE x Nyquist (radio.c:28) scaled to
    the actual sample rate."""

    samprate: int = 192000
    frequency: float = 0.0   # LO1, Hz
    min_IF: float = float("nan")
    max_IF: float = float("nan")

    def __post_init__(self):
        if np.isnan(self.min_IF):
            self.min_IF = -IF_EXCLUDE * self.samprate / 2
        if np.isnan(self.max_IF):
            self.max_IF = IF_EXCLUDE * self.samprate / 2


class Receiver:
    """Host wrapper: config, state on one named device, the per-block call
    and the control-plane tuning functions of radio.c.

    Every edit produces a new state or config between blocks; a "no
    recompile" swap (filter response, passband mask) is a new device
    tensor."""

    def __init__(self, cfg: ReceiverConfig, *, device):
        self.device = torch.device(device)
        self.cfg = cfg.to(self.device)
        self.state = receiver_init(cfg, device=self.device)
        self.sdr = SDRStatus(samprate=cfg.samprate)
        self.tune_freq = 0.0
        self.second_lo = 0.0   # LO2 Hz, mirrored for status emission
        self._load_filter_args()

    def _load_filter_args(self) -> None:
        """The current response and passband mask as device tensors."""
        self._resp = torch.as_tensor(self.cfg.response,
                                     dtype=torch.complex64, device=self.device)
        self._n0_mask = torch.as_tensor(self.cfg.n0_mask, device=self.device)

    def process(self, iq_block):
        """Run one L-sample complex block (numpy or tensor); returns
        (audio, diag) as tensors on the receiver's device."""
        x = torch.as_tensor(iq_block, dtype=torch.complex64,
                            device=self.device)
        self.state, audio, diag = receiver_step(
            self.cfg, self.state, x, self._resp, self._n0_mask)
        return audio, diag

    def process_offline(self, blocks_i16):
        """Demodulate (nblocks, L, 2) int16 I/Q in order (receiver_scan),
        scaled on the device as the JAX package's packed scan does.
        Returns the audio stacked (nblocks, ...) on the receiver's device."""
        x = torch.as_tensor(blocks_i16, dtype=torch.int16, device=self.device)
        self.state, audio = receiver_scan(
            self.cfg, self.state, iq_from_i16(x), self._resp, self._n0_mask)
        return audio

    # ---- control plane (radio.c:200-316) ----

    def lo2_in_range(self, f: float, avoid_alias: bool) -> bool:
        """LO2_in_range (radio.c:273-284)."""
        if avoid_alias:
            return (
                f >= self.sdr.min_IF + max(0.0, self.cfg.mode.high)
                and f <= self.sdr.max_IF + min(0.0, self.cfg.mode.low)
            )
        return abs(f) <= 0.5 * self.cfg.samprate

    def set_second_lo(self, second_lo: float) -> None:
        """set_second_LO (radio.c:290-301); phase is preserved."""
        self.second_lo = float(second_lo)
        f = 0.0 if second_lo == 0 else second_lo / self.cfg.samprate
        self.state = self.state._replace(lo2=set_osc(self.state.lo2, f))

    def set_doppler(self, freq: float, rate: float) -> None:
        """set_doppler (radio.c:180-184)."""
        fs = self.cfg.samprate
        self.state = self.state._replace(
            doppler=set_osc(self.state.doppler, -freq / fs, -rate / (fs * fs)))

    def set_freq(self, f: float, new_lo2: float = np.nan) -> Optional[float]:
        """set_freq (radio.c:204-242).  Tuning model: RF = LO1 - LO2.

        Returns the LO1 frequency the front end must move to, or None if
        LO2 absorbed the whole retune."""
        self.tune_freq = f
        lo1 = self.sdr.frequency
        if np.isnan(new_lo2) or not self.lo2_in_range(new_lo2, False):
            new_lo2 = -(f - lo1)
            if not self.lo2_in_range(new_lo2, True):
                new_lo2 = self.sdr.samprate / 4.0
        new_lo1 = f + new_lo2
        command = None
        if new_lo1 != lo1 and new_lo1 > 0:
            command = new_lo1
        if self.lo2_in_range(new_lo2, False):
            self.set_second_lo(new_lo2)
        return command

    def update_first_lo(self, actual_lo1: float) -> None:
        """Front-end status reported a (possibly quantized) LO1; retune LO2
        to compensate so RF stays put (radio_status.c:311-316)."""
        if self.sdr.frequency != actual_lo1:
            self.sdr.frequency = actual_lo1
            new_lo2 = -(self.tune_freq - actual_lo1)
            if self.lo2_in_range(new_lo2, False):
                self.set_second_lo(new_lo2)

    def set_gain_factor(self, g: float) -> None:
        self.state = self.state._replace(
            gain_factor=torch.full_like(self.state.gain_factor, g))

    def set_filter(self, low: float | None = None, high: float | None = None,
                   kaiser_beta: float | None = None) -> None:
        """Live filter edit (set_filter, filter.c:500-546): redesign the
        slave response and the n0 passband mask and swap them in as new
        device tensors.  The FM audio gain is recomputed from the new edges
        (fm.c:85-86 derives it from the current bandwidth every block)."""
        mode = self.cfg.mode
        low = mode.low if low is None else float(low)
        high = mode.high if high is None else float(high)
        if not (np.isfinite(low) and np.isfinite(high)):
            raise ValueError(f"non-finite filter edges: {low!r}, {high!r}")
        if high < low:
            low, high = high, low
        beta = (self.cfg.kaiser_beta if kaiser_beta is None
                else float(kaiser_beta))
        # isfinite BEFORE the clamp: max(0.0, nan) silently returns 0.0
        if not np.isfinite(beta) or beta > 100.0:
            raise ValueError(f"kaiser_beta out of range: {beta!r}")
        beta = max(0.0, beta)
        dsr = self.cfg.dsamprate
        response = set_filter_response(self.cfg.slave, low / dsr, high / dsr,
                                       beta)
        mask = passband_mask(self.cfg.master.N, self.cfg.samprate, low, high)
        demod_cfg = self.cfg.demod_cfg
        if mode.demod == "FM" and high != low:
            headroom = 10.0 ** (self.cfg.headroom_db / 20.0)
            demod_cfg = demod_cfg._replace(
                gain=float(headroom * (1.0 / np.pi) * self.cfg.dsamprate
                           / abs(low - high)))
        self.cfg = self.cfg._replace(
            mode=dc_replace(mode, low=low, high=high),
            response=response,
            n0_mask=mask,
            kaiser_beta=beta,
            demod_cfg=demod_cfg,
        )
        self._load_filter_args()

    def set_shift(self, shift_hz: float) -> None:
        """Post-detection frequency shift (set_shift, radio.c:304-316):
        retune the linear demod's shift oscillator without phase jump.
        No-op for AM/FM."""
        if self.cfg.mode.demod != "LINEAR":
            return
        new_shift = set_osc(self.state.demod.shift,
                            shift_hz / self.cfg.dsamprate)
        self.state = self.state._replace(
            demod=self.state.demod._replace(shift=new_shift))
        self.cfg = self.cfg._replace(
            mode=dc_replace(self.cfg.mode, shift=float(shift_hz)))

    def set_options(self, **changes) -> None:
        """Option-flag edits (display.c:958-986 'o' key): isb, pll, square,
        flat, channels (1/2), recovery_rate (dB/s), hangtime (s),
        headroom_db (dB).  The config and demod state rebuild; tuning state
        carries over."""
        headroom = changes.pop("headroom_db", self.cfg.headroom_db)
        if changes.get("square"):
            changes["pll"] = True   # square implies pll (display.c:966-969)
        self._rebuild(dc_replace(self.cfg.mode, **changes),
                      headroom_db=headroom)

    def set_blocksize(self, L: int, M: int | None = None) -> None:
        """Blocksize change (display.c:866-886 'b' key): M defaults to L+1
        as the reference does; the demod restarts, the overlap resets (its
        length changed), the tuning oscillators and the gain carry over."""
        old = self.state
        cfg = make_receiver_config(
            self.cfg.mode,
            samprate=self.cfg.samprate,
            out_rate=int(self.cfg.dsamprate),
            L=int(L),
            M=int(M) if M is not None else int(L) + 1,
            kaiser_beta=self.cfg.kaiser_beta,
            headroom_db=self.cfg.headroom_db,
            enable_pl=self.cfg.enable_pl,
        )
        self.cfg = cfg.to(self.device)
        self.state = receiver_init(cfg, device=self.device)._replace(
            lo2=old.lo2, doppler=old.doppler, gain_factor=old.gain_factor)
        self._load_filter_args()

    def set_mode(self, mode: str | ModeDef) -> None:
        """Runtime mode change (set_mode, radio.c:322-374): the config and
        demod state rebuild (a fresh demod thread's); the tuning
        oscillators keep their phase."""
        if isinstance(mode, str):
            mode = DEFAULT_MODES[mode.upper()]
        self._rebuild(mode, headroom_db=self.cfg.headroom_db)

    def _rebuild(self, mode: ModeDef, headroom_db: float) -> None:
        old = self.state
        cfg = make_receiver_config(
            mode,
            samprate=self.cfg.samprate,
            out_rate=int(self.cfg.dsamprate),
            L=self.cfg.master.L,
            M=self.cfg.master.M,
            kaiser_beta=self.cfg.kaiser_beta,
            headroom_db=headroom_db,
            enable_pl=self.cfg.enable_pl,
        )
        self.cfg = cfg.to(self.device)
        # carry oscillator phases and the master overlap across the switch
        self.state = receiver_init(cfg, device=self.device)._replace(
            overlap=old.overlap, lo2=old.lo2, doppler=old.doppler,
            gain_factor=old.gain_factor)
        self._load_filter_args()


def make_receiver(mode: str = "FM", *, device, **kw) -> Receiver:
    return Receiver(make_receiver_config(mode, **kw), device=device)
