"""FM demodulator on torch tensors (port of ``ka9q_sdr_tpu.models.demod_fm``,
the reference's fm.c).

Pipeline per block (fm.c:72-174):

1. SNR estimate from the amplitude's mean/variance driving a squelch with a
   one-block flush tail (fm.c:91-116).
2. Phase-difference discriminator ``carg(samp * conj(prev))`` with
   threshold extension: samples below 0.55x the average amplitude are
   blanked and replaced by the last good output (fm.c:118-144), computed
   with two forward fills (ops.ffill, the Hopper kernel on CUDA).
3. Post-detection audio chain: a REAL master filter at the output rate
   feeding a 300 Hz - 6 kHz de-emphasis slave (fm.c:51-67), and the PL-tone
   measurement slave with its 16k-point rFFT (pltask, fm.c:189-285).

The JAX package gates the PL rFFT with ``lax.cond(any(do_fft))``; in eager
PyTorch that test would stall the host on the device every block.  Here the
measurement is computed every block and selected per channel with
``torch.where(do_fft, ...)``: the same result, and nothing synchronises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_execute,
    slave_execute,
)
from ..ops.ffill import forward_fill
from ..ops.window import window_rfilter

__all__ = ["FMConfig", "FMState", "fm_init", "fm_demod"]

#: Squelch threshold, SNR as a power ratio (fm.c:108).
SNR_THRESH = 2.0
#: Threshold-extension blanking level relative to average amplitude (fm.c:121).
BLANK_RATIO = 0.55
#: PL slave decimation: 48 kHz -> 1.5 kHz (fm.c:201).
PL_DECIMATE = 32
#: PL analysis FFT size: (1<<19)/PL_DECIMATE = 16384 (fm.c:225).
PL_FFT_SIZE = (1 << 19) // PL_DECIMATE
#: Run the PL FFT every this many PL-rate samples (fm.c:251).
PL_FFT_INTERVAL = 512


class FMConfig(NamedTuple):
    """Static FM configuration.  Built once per (mode, rate) by `make`.

    The two responses are host arrays as designed; `to(device)` returns a
    copy holding them as tensors on a device, so a block uploads nothing."""

    dsamprate: float            # decimated (output) sample rate, Hz
    gain: float                 # audio gain constant (fm.c:86)
    flat: bool                  # FLAT mode: skip de-emphasis (fm.c:55)
    audio_master: MasterSpec    # REAL master at the output rate (fm.c:43)
    audio_slave: Optional[SlaveSpec]
    audio_response: object      # de-emphasis response (fm.c:56-65) or None
    pl_slave: Optional[SlaveSpec]
    pl_response: object         # <300 Hz low-pass (fm.c:208-218) or None

    @classmethod
    def make(
        cls,
        dsamprate: float,
        low: float,
        high: float,
        L_dec: int,
        M_dec: int,
        headroom_db: float = -15.0,
        kaiser_beta: float = 3.0,
        flat: bool = False,
        enable_pl: bool = True,
    ) -> "FMConfig":
        """Derive the audio chain exactly as demod_fm does at startup.

        L_dec/M_dec are the predetection filter's L/decimate and
        (M-1)/decimate+1 (fm.c:39-40)."""
        headroom = 10.0 ** (headroom_db / 20.0)
        gain = (headroom * (1.0 / np.pi) * dsamprate) / abs(low - high)
        am_spec = MasterSpec(L_dec, M_dec, FilterType.REAL)
        AN = am_spec.N
        audio_slave = audio_response = None
        if not flat:
            filter_gain = 10.0 / AN  # subjective volume bump (fm.c:42)
            j = np.arange(AN // 2 + 1)
            f = j * dsamprate / AN
            aresp = np.where(
                (f >= 300.0) & (f <= 6000.0),
                filter_gain * 300.0 / np.maximum(f, 1.0),
                0.0,
            ).astype(np.complex128)
            audio_response = window_rfilter(L_dec, M_dec, aresp, kaiser_beta).astype(
                np.complex64
            )
            audio_slave = SlaveSpec(am_spec, 1, FilterType.REAL)
        pl_slave = pl_response = None
        if enable_pl:
            PL_N = AN // PL_DECIMATE
            PL_L = L_dec // PL_DECIMATE
            PL_M = PL_N - PL_L + 1
            j = np.arange(PL_N // 2 + 1)
            f = j * dsamprate / AN  # relative to the input rate (fm.c:214)
            presp = np.where((f > 0) & (f < 300.0), 1.0, 0.0).astype(np.complex128)
            pl_response = window_rfilter(PL_L, PL_M, presp, 2.0).astype(np.complex64)
            pl_slave = SlaveSpec(am_spec, PL_DECIMATE, FilterType.REAL)
        return cls(
            dsamprate=float(dsamprate),
            gain=float(gain),
            flat=flat,
            audio_master=am_spec,
            audio_slave=audio_slave,
            audio_response=audio_response,
            pl_slave=pl_slave,
            pl_response=pl_response,
        )

    def to(self, device) -> "FMConfig":
        """This config with its responses as complex64 tensors on `device`."""
        def put(resp):
            return None if resp is None else torch.as_tensor(
                resp, dtype=torch.complex64, device=device)

        return self._replace(audio_response=put(self.audio_response),
                             pl_response=put(self.pl_response))


class FMState(NamedTuple):
    disc_state: torch.Tensor     # complex64, conj of last strong sample (fm.c:26)
    lastaudio: torch.Tensor      # float32, last good discriminator output (fm.c:69)
    snr_below: torch.Tensor      # int32, blocks below squelch threshold (fm.c:70)
    audio_overlap: torch.Tensor  # audio master overlap (..., M_dec-1) float32
    pl_ring: Optional[torch.Tensor]     # (..., PL_FFT_SIZE) float32, newest last
    pl_counter: Optional[torch.Tensor]  # int32, PL samples since last FFT
    plfreq: Optional[torch.Tensor]      # float32, measured tone (NaN = none)


def fm_init(cfg: FMConfig, batch_shape=(), *, device) -> FMState:
    shape = tuple(batch_shape)
    pl_ring = pl_counter = plfreq = None
    if cfg.pl_slave is not None:
        pl_ring = torch.zeros(shape + (PL_FFT_SIZE,), dtype=torch.float32,
                              device=device)
        pl_counter = torch.zeros(shape, dtype=torch.int32, device=device)
        plfreq = torch.full(shape, float("nan"), dtype=torch.float32,
                            device=device)
    return FMState(
        disc_state=torch.ones(shape, dtype=torch.complex64, device=device),
        lastaudio=torch.zeros(shape, dtype=torch.float32, device=device),
        snr_below=torch.zeros(shape, dtype=torch.int32, device=device),
        audio_overlap=torch.zeros(shape + (cfg.audio_master.M - 1,),
                                  dtype=torch.float32, device=device),
        pl_ring=pl_ring,
        pl_counter=pl_counter,
        plfreq=plfreq,
    )


def _pl_measure(cfg: FMConfig, ring: torch.Tensor,
                prev: torch.Tensor) -> torch.Tensor:
    """Peak-pick the PL spectrum (fm.c:254-276).

    A strong peak outside 67-255 Hz leaves plfreq at its previous value
    (fm.c:270-276 only assigns inside the range check); a weak peak (<1% of
    total energy) clears it to NaN."""
    spec = torch.fft.rfft(ring, dim=-1)
    energy = spec.real ** 2 + spec.imag ** 2
    energy = energy[..., 1: PL_FFT_SIZE // 2]  # skip DC (fm.c:260)
    peakenergy, peak = torch.max(energy, dim=-1)
    totenergy = torch.sum(energy, dim=-1)
    pl_samprate = cfg.dsamprate / PL_DECIMATE
    f = (peak + 1).to(torch.float32) * (pl_samprate / PL_FFT_SIZE)
    strong = peakenergy > 0.01 * totenergy
    in_range = (f > 67.0) & (f < 255.0)
    return torch.where(strong, torch.where(in_range, f, prev),
                       torch.full_like(f, float("nan")))


def fm_demod(
    cfg: FMConfig, state: FMState, baseband: torch.Tensor
) -> tuple[FMState, torch.Tensor, dict]:
    """One block of FM demodulation (fm.c:72-174).

    baseband: (..., n) complex64 from the predetection slave filter.
    Returns (state, mono_audio, diag)."""
    n = baseband.shape[-1]
    dev = baseband.device
    sampsq = baseband.real ** 2 + baseband.imag ** 2
    bb_power = torch.sum(sampsq, dim=-1) / (2.0 * n)
    amp = torch.sqrt(sampsq)
    amp_mean = torch.mean(amp, dim=-1)
    avg_amp = amp_mean / np.sqrt(2.0)
    # centered variance: the reference's bb_power - avg_amp^2 (fm.c:101)
    # cancels catastrophically in float32 on constant-envelope signals
    fm_variance = torch.mean((amp - amp_mean[..., None]) ** 2, dim=-1) / 2.0
    snr = torch.clamp_min(
        avg_amp * avg_amp / torch.clamp_min(2.0 * fm_variance, 1e-30) - 1.0,
        0.0,
    )

    # Squelch counter (fm.c:108-114)
    snr_below = torch.where(
        snr > SNR_THRESH,
        torch.zeros_like(state.snr_below),
        torch.clamp_max(state.snr_below + 1, 1000),
    )
    open_ = snr_below < 2   # open, or one extra flush block (fm.c:115-116)
    fresh = snr_below < 1   # fully open: update foffset/pdeviation (fm.c:146)

    # Threshold extension + discriminator (fm.c:118-144), parallel form:
    # the "strictly previous strong sample" each position pairs with is the
    # fill lagged one sample, so two fills serve the whole block.
    min_ampl = (BLANK_RATIO ** 2) * avg_amp * avg_amp
    strong = sampsq > min_ampl[..., None]

    ff_conj = forward_fill(torch.conj_physical(baseband), strong,
                           state.disc_state)
    prev_conj = torch.cat([state.disc_state[..., None], ff_conj[..., :-1]],
                          dim=-1)
    disc = torch.angle(baseband * prev_conj)

    ff_disc = forward_fill(disc, strong, state.lastaudio)
    weak_fill = torch.cat([state.lastaudio[..., None], ff_disc[..., :-1]],
                          dim=-1)
    samples_open = torch.where(strong, disc, weak_fill)

    # fill-at-end IS the carried state (equals the init when no strong
    # sample occurred)
    new_disc_state = torch.where(open_, ff_conj[..., -1],
                                 torch.zeros_like(state.disc_state))
    new_lastaudio = torch.where(open_, ff_disc[..., -1],
                                torch.zeros_like(state.lastaudio))
    samples = torch.where(open_[..., None], samples_open,
                          torch.zeros_like(samples_open))

    nan = torch.full_like(snr, float("nan"))
    avg_f = torch.mean(samples_open, dim=-1)
    foffset = torch.where(fresh, cfg.dsamprate * avg_f / (2.0 * np.pi), nan)
    # Peak deviation tracks STRONG samples only (fm.c:133-139); a leading
    # weak run carries the previous block's lastaudio and is not counted,
    # and when the first sample is weak the running peaks start at 0.
    any_strong = torch.any(strong, dim=-1)
    smax = torch.amax(torch.where(strong, disc, -torch.inf), dim=-1)
    smin = torch.amin(torch.where(strong, disc, torch.inf), dim=-1)
    first_strong = strong[..., 0]
    pmax = torch.where(first_strong, smax, torch.clamp_min(smax, 0.0))
    pmin = torch.where(first_strong, smin, torch.clamp_max(smin, 0.0))
    zero = torch.zeros_like(pmax)
    pdev_pos = torch.where(any_strong, pmax, zero) - avg_f
    pdev_neg = torch.where(any_strong, pmin, zero) - avg_f
    pdeviation = torch.where(
        fresh,
        cfg.dsamprate * torch.maximum(pdev_pos, -pdev_neg) / (2.0 * np.pi),
        nan,
    )

    # Post-detection audio chain (fm.c:162-172); flat mode with PL off has
    # no consumer of the audio-master FFT.
    if cfg.flat and cfg.pl_slave is None:
        new_overlap, afdomain = state.audio_overlap, None
        audio = samples
    else:
        new_overlap, afdomain = master_execute(
            cfg.audio_master, state.audio_overlap, samples
        )
        if cfg.flat:
            audio = samples
        else:
            resp = torch.as_tensor(cfg.audio_response, device=dev)
            audio = slave_execute(cfg.audio_slave, afdomain, resp) * cfg.gain

    # PL tone measurement (pltask, fm.c:233-277), selected per channel
    pl_ring, pl_counter, plfreq = state.pl_ring, state.pl_counter, state.plfreq
    if cfg.pl_slave is not None:
        pl_samples = slave_execute(
            cfg.pl_slave, afdomain, torch.as_tensor(cfg.pl_response, device=dev)
        )
        k = pl_samples.shape[-1]
        pl_ring = torch.cat([pl_ring[..., k:], pl_samples], dim=-1)
        pl_counter = pl_counter + k
        do_fft = pl_counter >= PL_FFT_INTERVAL
        plfreq = torch.where(do_fft, _pl_measure(cfg, pl_ring, plfreq), plfreq)
        pl_counter = torch.where(do_fft, torch.zeros_like(pl_counter),
                                 pl_counter)

    new_state = FMState(
        disc_state=new_disc_state,
        lastaudio=new_lastaudio,
        snr_below=snr_below,
        audio_overlap=new_overlap,
        pl_ring=pl_ring,
        pl_counter=pl_counter,
        plfreq=plfreq,
    )
    diag = {
        "snr": snr,
        "bb_power": bb_power,
        "foffset": foffset,
        "pdeviation": pdeviation,
        "squelch_open": open_,
        "plfreq": plfreq,
    }
    return new_state, audio, diag
