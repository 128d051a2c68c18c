"""The runner's rows held against reference outputs that the JAX package
made: one ``np.savez_compressed`` file a row under ``data/reference/``.

Each row is a row of ``python -m ka9q_sdr_tpu_torch.bench`` at its
defaults: its geometry, its input block (``bench.bench_inputs`` /
``bench.mixed_inputs``, bit for bit bench.py's) and its mode.  The row's
one block is fed K times in a row to a fresh bank, as the runner repeats
it.  The reference went through the JAX package's banks on its CPU backend
(``ChannelBank.process_i16_pcm``, or ``MultiBank.process`` for the mixed
row), one block a call; the script that writes the files is
``tests/test_torch_reference.py`` (``JAX_PLATFORMS=cpu python
tests/test_torch_reference.py --write``), since this package never imports
JAX.

- R1: FM+PL 8192 ch x 393.216 Msps, L 58,195,968, M 8,912,897 (N =
  2^26), K = 3; ``process_i16_pcm``.
- R2: FM+PL 4096 ch, L 7,864,320, M 8,912,897 (N = 2^24), K = 24;
  ``process_i16_pcm``, and ``process_scan_i16(pcm_out=True)`` in chunks
  of 8.
- R3: MultiBank FM:5120 + USB:512 + CAM:512, 20 ms, float32 ingest,
  K = 24; ``MultiBank.process``.
- R4: CAM 4096 ch x 393.216 Msps, L 7,864,320, M 8,912,897, K = 36;
  ``process_i16_pcm``.
- R5: CAM 2048 ch x 24.576 Msps, L 491,520, M 557,057 (N = 2^20), K =
  36; ``process_scan_i16(pcm_out=True)`` in chunks of 8, the rest one
  block a call.
- R6 / R7: FM+PL 5120 / 6144 ch at R2's geometry, K = 24; step and scan.
- R8: FM+PL 2048 ch on R1's long blocks (the scaling row), K = 3; step.
- R9: MultiBank FM:3072 + USB:512 + CAM:512, 20 ms, float32 ingest, K =
  24; ``MultiBank.process``.
- M1 (not a runner row): R2's geometry and noise with its three carriers
  FM-modulated (``modulated_input``: a voice-band tone at 3 kHz and a PL
  tone at 500 Hz peak deviation each), K = 36, so that the PL FFT fires
  twice (after blocks 17 and 35); step and scan.

A file holds the SHA-256 of the input block's bytes; for every block and
channel the flag the diag carries (FM ``squelch_open``, the linear modes'
``pll_lock``) and the audio RMS (float32, full scale 1: the PCM / 32767,
or the float audio of the mixed row); the int16 PCM of the kept channels
(each carrier channel and its two neighbours, plus up to ``N_NOISE``
evenly spaced noise channels; the mixed row's PCM is the daemons'
``io.pcm.scaleclip_int16`` of its float audio); the integer state after
the last block (``k``, ``r``, ``dr``, the channel NCO's phase and
frequency words, ``pl_counter`` and the PLL's ``lock_count``,
``fft_samples`` and ``pll_lock``, per group); where the bank measures PL
tones (R6-R8, M1; R1 and R2 were made before the record held it) the
kept channels' ``plfreq``, per block from the diag and after the last
block from the state, with the width of a PL bin; and metadata (the
geometry, K, the versions and the command that made it).

The bounds (the thresholds stated before any run on a card; the domain of
the audio bounds corrected after the first runs, see below):

- the integer state: bit-equal;
- the flags: equal on every channel from block 1 on, and on the carrier
  channels in block 0 (in a cold bank's first block the FM squelch is open
  on every channel, and a noise channel's discriminator turns the master
  FFT's float32 rounding into other blanked runs, ROADMAP §3 item 13); the
  count that differs in block 0 is printed;
- the kept channels' PCM (PARITY.md #9): at most ``PCM_LSB`` LSB at any
  sample and a difference RMS at most ``PCM_RMS_DBFS`` dBFS;
- the audio RMS: within ``RMS_DB`` dB on every channel and block whose
  flags agree (a block of a scan carries no diag: every channel) and
  whose reference RMS is above ``RMS_FLOOR_DBFS`` dBFS;
- the measured PL tone on each FM carrier, in every block whose diag
  both runs carry and after the last block: equal to the reference's
  (NaN for NaN) or at most one PL bin (1500 / 16384 Hz) away, since the
  peak-pick may part a near-tie of two bins (``torch.max`` against
  ``jnp.argmax``); the readings one bin away are counted and a noise
  channel's tone (a peak of noise) is only printed.

The audio bounds hold from a channel's first bound block on (``first_pcm``
/ ``first_rms``): an FM carrier's from block 0; a carrier of an AGC mode
(AM, the linear modes) has its PCM bound from block 1, since in a cold
bank's first block the hang AGC magnifies the FFT libraries' rounding on
the filter's rising edge (ROADMAP §3 item 5; 49-196 LSB, 1 LSB from block
1), and its RMS from block 0; a noise channel's from block 1, and an FM
noise channel's ``lag`` blocks later still.  The flags domain leaves out
the FM noise channels' block 0 (item 13), and an FM block's audio holds
the discriminator's samples of the blocks that the post-detection
filter's memory spans: ``lag = ceil((M_dec - 1) / L_dec)`` blocks before
it (1 on long blocks, 2 at 20 ms).  The first runs found item 13's block
0 there (R1: 279 LSB on a kept noise channel in block 1; R1 and R3:
0.2-1.05 dB on 1-3 noise channels in block 1, on the card and the CPU
alike), so
the audio domain follows the flags domain through that memory; the
thresholds are unchanged.  Every figure outside the domain is printed.

Usage (the port's side; on the first card unless ``--cpu``):
  python -m ka9q_sdr_tpu_torch.tools.reference [--rows R5] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..bench import bench_inputs, mixed_inputs
from ..io.pcm import scaleclip_int16
from ..models.bank import ChannelBank, MultiBank, make_bank_config
from ..models.demod_fm import PL_DECIMATE, PL_FFT_INTERVAL, PL_FFT_SIZE
from ..ops import agc, ffill
from ..utils.runtime import configure_torch
from ..utils.timing import cuda_ms

__all__ = ["Row", "ROWS", "REF_DIR", "SCAN_CHUNK", "N_NOISE", "PCM_LSB",
           "PCM_RMS_DBFS", "RMS_DB", "RMS_FLOOR_DBFS", "PL_TOL_HZ",
           "M1_TONES", "row_input", "bench_noise", "quantise_i16",
           "modulated_input", "fm_phase", "input_sha256",
           "carrier_channels", "kept_channels", "first_bound", "pl_bin",
           "pl_firings", "Record", "int_state", "diag_flags", "plfreq_of",
           "check_pl_tones", "save", "load", "check_input", "run_port",
           "Report", "compare", "main"]

#: where the reference files live (``<row>.npz``)
REF_DIR = Path(__file__).resolve().parent.parent / "data" / "reference"
#: blocks a call of a scan plan
SCAN_CHUNK = 8
#: noise channels kept a row, beside the carriers and their neighbours
N_NOISE = 4

#: PARITY.md #9 on the kept channels' int16 PCM
PCM_LSB = 8
PCM_RMS_DBFS = -85.0
#: the audio RMS of a channel, where the flags agree
RMS_DB = 0.1
RMS_FLOOR_DBFS = -90.0
#: a modulated row's input check: each carrier's measured PL tone within
#: this of the tone that modulates it, after every firing of the PL FFT
PL_TOL_HZ = 1.0

_BANK_FIELDS = ("k", "r", "dr")
_NCO_FIELDS = ("phase", "freq")
_DEMOD_FIELDS = ("pl_counter", "lock_count", "fft_samples", "pll_lock")


@dataclasses.dataclass(frozen=True)
class Row:
    """One row: a bank (``mode``) or a MultiBank (``groups``) at a
    geometry, K blocks, and the port's call plans ("step": one block a
    call; "scan": ``process_scan_i16(pcm_out=True)`` in chunks of
    SCAN_CHUNK, the rest one block a call).  ``tones``, one a carrier:
    (voice Hz, its peak deviation Hz, PL Hz, its peak deviation Hz); a
    row with tones takes ``modulated_input`` and is no runner row."""

    name: str
    label: str
    samprate: float
    L: int
    M: int
    K: int
    mode: str | None = None
    n_channels: int = 0
    groups: tuple = ()
    cfg: tuple = ()
    calls: tuple = ("step",)
    tones: tuple = ()

    @property
    def total(self) -> int:
        return sum(n for _, n in self.groups) if self.groups else \
            self.n_channels

    def geometry(self) -> dict:
        """What a reference file records of the row (JSON-ready)."""
        return {"mode": self.mode, "n_channels": self.total,
                "groups": [list(g) for g in self.groups],
                "samprate": self.samprate, "L": self.L, "M": self.M,
                "cfg": dict(self.cfg)}


_FS = 393.216e6
_L20, _M20 = 7864320, 8912897
_LONG = 58195968
_PL = (("enable_pl", True),)
#: M1's carriers, on channels 3, n/2 and n-5: a voice-band tone at 3 kHz
#: and a PL tone at 500 Hz peak deviation each
M1_TONES = ((1000, 3000, 100, 500), (1500, 3000, 150, 500),
            (700, 3000, 200, 500))
ROWS = {r.name: r for r in (
    Row("R1", "FM+PL 8192 ch long blocks (the headline)", _FS, _LONG, _M20,
        3, mode="FM", n_channels=8192, cfg=_PL),
    Row("R2", "FM+PL 4096 ch 20 ms (serving)", _FS, _L20, _M20, 24,
        mode="FM", n_channels=4096, cfg=_PL, calls=("step", "scan")),
    Row("R3", "MultiBank FM:5120 + USB:512 + CAM:512 20 ms (mixed)", _FS,
        _L20, _M20, 24, groups=(("FM", 5120), ("USB", 512), ("CAM", 512))),
    Row("R4", "CAM 4096 ch 20 ms (CAM wide)", _FS, _L20, _M20, 36,
        mode="CAM", n_channels=4096),
    Row("R5", "CAM 2048 ch x 24.576 Msps (CAM small)", 24.576e6, 491520,
        557057, 36, mode="CAM", n_channels=2048, calls=("scan",)),
    Row("R6", "FM+PL 5120 ch 20 ms (serving)", _FS, _L20, _M20, 24,
        mode="FM", n_channels=5120, cfg=_PL, calls=("step", "scan")),
    Row("R7", "FM+PL 6144 ch 20 ms (serving)", _FS, _L20, _M20, 24,
        mode="FM", n_channels=6144, cfg=_PL, calls=("step", "scan")),
    Row("R8", "FM+PL 2048 ch long blocks (scaling)", _FS, _LONG, _M20, 3,
        mode="FM", n_channels=2048, cfg=_PL),
    Row("R9", "MultiBank FM:3072 + USB:512 + CAM:512 20 ms (mixed)", _FS,
        _L20, _M20, 24, groups=(("FM", 3072), ("USB", 512), ("CAM", 512))),
    Row("M1", "FM+PL 4096 ch 20 ms, carriers FM-modulated by a voice tone "
        "and a PL tone", _FS, _L20, _M20, 36, mode="FM", n_channels=4096,
        cfg=_PL, calls=("step", "scan"), tones=M1_TONES),
)}


def row_input(row: Row):
    """The row's frequencies (a list, or the MultiBank's groups) and its
    one input block: (L, 2) int16 for a bank, (L, 2) float32 for the
    MultiBank."""
    if row.groups:
        return mixed_inputs(list(row.groups), row.samprate, row.L)
    if row.tones:
        return modulated_input(row)
    return bench_inputs(row.n_channels, row.samprate, row.L)


def bench_noise(L: int) -> np.ndarray:
    """bench_inputs' complex noise, bit for bit: default_rng(1) at 0.01."""
    rng = np.random.default_rng(1)
    return 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))


def quantise_i16(x: np.ndarray) -> np.ndarray:
    """bench_inputs' (L,) complex -> (L, 2) int16, bit for bit."""
    x = x.astype(np.complex64)
    x_i = np.empty((x.shape[0], 2), np.int16)
    x_i[:, 0] = np.clip(x.real * 32767, -32768, 32767)
    x_i[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
    return x_i


def _cycles(f: float, n: np.ndarray, fs: int, L: int) -> np.ndarray:
    """The cycles of a whole-Hz frequency f at samples n, modulo 1, from
    (f n) mod fs in int64 (exact); raises unless a block of L samples
    holds whole cycles of f."""
    if not float(f).is_integer() or (int(f) * L) % fs:
        raise ValueError(f"{f} Hz makes no whole number of cycles in a "
                         f"block of {L} samples at {fs} Hz: the repeated "
                         "block would step in phase")
    return (int(f) * n % fs) / fs


def fm_phase(fc: float, tone: tuple, n: np.ndarray, fs: int,
             L: int) -> np.ndarray:
    """A carrier's phase at samples n in closed form, 2 pi fc t + (da / fa)
    sin(2 pi fa t) + (dp / fp) sin(2 pi fp t): the exact integral of the
    instantaneous frequency fc + da cos(2 pi fa t) + dp cos(2 pi fp t).
    Every frequency makes whole cycles in a block (``_cycles``), so the
    block repeated is one continuous signal."""
    fa, da, fp, dp = tone
    two_pi = 2.0 * np.pi
    return (two_pi * _cycles(fc, n, fs, L)
            + (da / fa) * np.sin(two_pi * _cycles(fa, n, fs, L))
            + (dp / fp) * np.sin(two_pi * _cycles(fp, n, fs, L)))


def modulated_input(row: Row):
    """A modulated row's frequencies and (L, 2) int16 block: bench_inputs'
    channels and noise, with a 0.2 carrier on each carrier channel
    FM-modulated by the row's tones (``fm_phase``)."""
    fs, L = int(row.samprate), row.L
    if fs != row.samprate:
        raise ValueError(f"{row.samprate} Hz is no whole number of Hz")
    usable = 0.9 * row.samprate
    freqs = list(np.linspace(-usable / 2, usable / 2, row.n_channels,
                             endpoint=False))
    n = np.arange(L, dtype=np.int64)
    x = bench_noise(L)
    for ch, tone in zip(carrier_channels(row), row.tones, strict=True):
        x += 0.2 * np.exp(1j * fm_phase(freqs[ch], tone, n, fs, L))
    return freqs, quantise_i16(x)


def input_sha256(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def carrier_channels(row: Row) -> list:
    """The channels the input puts a carrier on: 3, n/2 and n-5 of a bank
    (bench.py:40-54); each group's middle channel of a MultiBank, indexed
    over the groups in order."""
    if row.groups:
        out, off = [], 0
        for _, n in row.groups:
            out.append(off + n // 2)
            off += n
        return out
    n = row.n_channels
    return [3, n // 2, n - 5]


def kept_channels(row: Row) -> np.ndarray:
    """Each carrier channel and its two neighbours, then up to N_NOISE
    noise channels, each the free channel nearest an evenly spaced mark."""
    n = row.total
    near = sorted({c + d for c in carrier_channels(row) for d in (-1, 0, 1)
                   if 0 <= c + d < n})
    taken, noise = set(near), []
    for i in range(min(N_NOISE, n - len(near))):
        c = _nearest_free(int((i + 0.5) * n / N_NOISE), taken, n)
        taken.add(c)
        noise.append(c)
    return np.asarray(near + sorted(noise), np.int64)


def _nearest_free(c: int, taken: set, n: int) -> int:
    for d in range(n):
        for e in (c - d, c + d):
            if 0 <= e < n and e not in taken:
                return e
    raise ValueError("no free channel")


def _decimate(row: Row) -> int:
    """The bank's decimation to its 48 kHz output rate."""
    return round(row.samprate / 48000.0)


def pl_bin(row: Row) -> float:
    """The width in Hz of a bin of the PL FFT: the PL rate (the output
    rate over PL_DECIMATE) over PL_FFT_SIZE."""
    return row.samprate / _decimate(row) / PL_DECIMATE / PL_FFT_SIZE


def _positions(kept, channels) -> list:
    """Where each of `channels` sits among the kept channels."""
    pos = {c: i for i, c in enumerate(np.asarray(kept).tolist())}
    return [pos[c] for c in np.asarray(channels).tolist()]


def first_bound(row: Row):
    """Each channel's first block whose audio the bounds hold, (B,) int8
    for the PCM and for the RMS (module docstring): an FM carrier 0 and 0,
    a carrier of an AGC mode 1 and 0, a noise channel 1 and 1, an FM one
    1 + lag and 1 + lag."""
    decimate = _decimate(row)
    L_dec, M_dec = row.L // decimate, (row.M - 1) // decimate + 1
    lag = -(-(M_dec - 1) // L_dec)
    modes = [m for m, n in row.groups for _ in range(n)] if row.groups \
        else [row.mode] * row.n_channels
    fm = np.asarray([m == "FM" for m in modes])
    carrier = np.zeros(len(modes), bool)
    carrier[carrier_channels(row)] = True
    noise = np.where(fm, 1 + lag, 1)
    first_pcm = np.where(carrier, np.where(fm, 0, 1), noise)
    first_rms = np.where(carrier, 0, noise)
    return first_pcm.astype(np.int8), first_rms.astype(np.int8)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rms(out: np.ndarray) -> np.ndarray:
    """(B, n) int16 PCM or float audio -> (B,) float32 RMS, full scale 1."""
    a = out.reshape(out.shape[0], -1).astype(np.float64)
    if out.dtype == np.int16:
        a = a / 32767.0
    return np.sqrt(np.mean(a * a, axis=-1)).astype(np.float32)


def int_state(states) -> dict:
    """The integer state of each group's bank state (a list of the JAX
    package's or the port's BankState trees): ``g<i>.<field>`` -> int64."""
    out = {}
    for g, s in enumerate(states):
        leaves = [(f, getattr(s, f)) for f in _BANK_FIELDS]
        leaves += [(f"nco.{f}", getattr(s.nco, f)) for f in _NCO_FIELDS]
        leaves += [(f"demod.{f}", getattr(s.demod, f, None))
                   for f in _DEMOD_FIELDS]
        for name, v in leaves:
            if v is not None:
                out[f"g{g}.{name}"] = _np(v).astype(np.int64)
    return out


def plfreq_of(parts):
    """The measured PL tone of every channel, (B,) float32 over the groups
    in order, from (plfreq or None, channels) a group (NaN where a group
    measures none); None where no group measures one."""
    if all(p is None for p, _ in parts):
        return None
    return np.concatenate([np.full(n, np.nan, np.float32) if p is None
                           else _np(p).astype(np.float32) for p, n in parts])


def pl_firings(row: Row) -> list:
    """The blocks after which the PL FFT fires on a fresh bank: each block
    adds L_dec / PL_DECIMATE samples to a counter that fires and restarts
    at PL_FFT_INTERVAL (demod_fm.fm_demod)."""
    per = row.L // _decimate(row) // PL_DECIMATE
    out, c = [], 0
    for b in range(row.K):
        c += per
        if c >= PL_FFT_INTERVAL:
            out.append(b)
            c = 0
    return out


def check_pl_tones(row: Row, arrays: dict) -> str:
    """A modulated row's input check, not a bound on the port: after every
    firing of the PL FFT (from the diag) and after the last block (from
    the state) each carrier's measured tone is within PL_TOL_HZ of the PL
    tone that modulates it.  Raises if not; returns what it read."""
    car = _positions(arrays["kept"], arrays["carriers"])
    want = np.asarray([t[2] for t in row.tones], np.float64)
    fired = pl_firings(row)
    if not fired:
        raise ValueError(f"{row.name}: the PL FFT fires in none of its "
                         f"{row.K} blocks")
    reads = [(f"block {b}", arrays["plfreq"][b, car]) for b in fired]
    reads.append(("end", arrays["plfreq_end"][car]))
    for label, got in reads:
        if not np.all(np.abs(got - want) <= PL_TOL_HZ):
            raise ValueError(f"{row.name}: measured PL tones {got} Hz "
                             f"({label}), not the {want} Hz that modulate "
                             "the carriers")
    return "; ".join(f"{label} {np.round(got, 4).tolist()} Hz"
                     for label, got in reads)


class Record:
    """What a run of a row leaves: per block the flags (or none, for a
    block of a scan), the RMS of every channel, the kept channels' PCM and
    measured PL tone; then the integer state and the PL tone it holds."""

    def __init__(self, row: Row):
        self.row = row
        self.kept = kept_channels(row)
        self.first_pcm, self.first_rms = first_bound(row)
        self.flags, self.flagged, self.rms, self.pcm = [], [], [], []
        self.plfreq = []

    def add(self, out, flags=None, plfreq=None) -> None:
        """One block: out (B, L_dec) int16 PCM or float audio, flags (B,)
        and plfreq (B,) or None (a block of a scan), on the host or the
        device."""
        out = _np(out)
        self.rms.append(_rms(out))
        kept = out[self.kept]
        self.pcm.append(kept if kept.dtype == np.int16
                        else scaleclip_int16(kept))
        self.flagged.append(flags is not None)
        self.flags.append(np.zeros(out.shape[0], bool) if flags is None
                          else _np(flags).astype(bool))
        self.plfreq.append(np.full(len(self.kept), np.nan, np.float32)
                           if plfreq is None else
                           _np(plfreq).astype(np.float32)[self.kept])

    def add_diag(self, out, diag) -> None:
        """One block of a bank: its output and its diag."""
        self.add(out, diag_flags(diag), diag.get("plfreq"))

    def add_groups(self, outs) -> None:
        """One block of a MultiBank: [(audio, diag), ...] a group."""
        self.add(np.concatenate([_np(a) for a, _ in outs]),
                 np.concatenate([_np(diag_flags(d)) for _, d in outs]),
                 plfreq_of([(d.get("plfreq"), len(a)) for a, d in outs]))

    def arrays(self, states) -> dict:
        d = {"flags": np.stack(self.flags), "flagged": np.asarray(
            self.flagged), "rms": np.stack(self.rms), "pcm": np.stack(
                self.pcm), "kept": self.kept, "first_pcm": self.first_pcm,
             "first_rms": self.first_rms, "carriers": np.asarray(
                    carrier_channels(self.row), np.int64)}
        d.update({f"state.{k}": v for k, v in int_state(states).items()})
        end = plfreq_of([(getattr(s.demod, "plfreq", None),
                          s.nco.phase.shape[0]) for s in states])
        if end is not None:
            d.update(plfreq=np.stack(self.plfreq), plfreq_end=end[self.kept],
                     pl_bin=np.float64(pl_bin(self.row)))
        return d


def save(path, arrays: dict, sha256: str, meta: dict) -> None:
    np.savez_compressed(path, sha256=np.asarray(sha256),
                        meta=np.asarray(json.dumps(meta, sort_keys=True)),
                        **arrays)


def load(name_or_path) -> dict:
    """A reference file as a dict of arrays; ``meta`` parsed, ``sha256``
    a string."""
    p = Path(name_or_path)
    if p.suffix != ".npz":
        p = REF_DIR / f"{name_or_path}.npz"
    with np.load(p) as z:
        d = {k: z[k] for k in z.files}
    d["meta"] = json.loads(str(d["meta"]))
    d["sha256"] = str(d["sha256"])
    return d


# --- the port's side --------------------------------------------------------

def run_port(row: Row, device, call: str = "step", x=None, freqs=None,
             timing_iters: int = 0):
    """The row through the port's bank on `device` by the call plan `call`.
    x / freqs: the row's input, if the caller made it already.

    Returns (record arrays, stats): stats["launches"] the fill and AGC
    kernel launches and stats["replays"] the graph replays over the checked
    blocks; stats["ms"], with timing_iters on a card, the device ms a block
    by CUDA events around that many more calls of the plan's unit (one
    block, or a chunk of SCAN_CHUNK) after them, else None."""
    if call not in ("step", "scan") or (row.groups and call != "step"):
        raise ValueError(f"{row.name}: no {call!r} plan")
    device = torch.device(device)
    if x is None:
        freqs, x = row_input(row)
    out = _drive(row, device, call, x, freqs, timing_iters)
    gc.collect()              # the wrapper's graphs and pools, before the
    if device.type == "cuda":  # next row captures its own
        torch.cuda.empty_cache()
    return out


def _drive(row, device, call, x, freqs, timing_iters):
    rec = Record(row)
    x_dev = torch.as_tensor(x, device=device)
    if row.groups:
        wrapper = MultiBank(freqs, samprate=row.samprate, L=row.L, M=row.M,
                            device=device, **dict(row.cfg))

        def one():
            return (wrapper.process(x_dev),)
        add = rec.add_groups
    else:
        cfg = make_bank_config(row.n_channels, row.mode,
                               samprate=row.samprate, L=row.L, M=row.M,
                               **dict(row.cfg))
        wrapper = ChannelBank(cfg, freqs, device=device)

        def one():
            return wrapper.process_i16_pcm(x_dev)
        add = rec.add_diag
    counts = (ffill.launches, agc.launches,
              sum(g.replays for g in wrapper.graphs))
    unit, n_unit, done = one, 1, 0
    if call == "scan":
        xs = x_dev.expand((SCAN_CHUNK,) + tuple(x_dev.shape)).contiguous()

        def unit():
            return wrapper.process_scan_i16(xs, pcm_out=True)

        n_unit = SCAN_CHUNK
        while row.K - done >= SCAN_CHUNK:
            for pcm in unit():
                rec.add(pcm)
            done += SCAN_CHUNK
    for _ in range(row.K - done):
        add(*one())
    stats = {"launches": {"ffill": ffill.launches - counts[0],
                          "agc": agc.launches - counts[1]},
             "replays": sum(g.replays for g in wrapper.graphs) - counts[2],
             "ms": None}
    arrays = rec.arrays(wrapper.states if row.groups else [wrapper.state])
    if timing_iters and device.type == "cuda":
        stats["ms"] = cuda_ms(unit, timing_iters) / n_unit
    return arrays, stats


def diag_flags(diag):
    """The flag a diag carries: FM ``squelch_open``, else ``pll_lock``."""
    return diag["squelch_open" if "squelch_open" in diag else "pll_lock"]


@dataclasses.dataclass
class Report:
    """A run against its reference, per block: the flags that differ (all
    channels where both carry flags; -1 where the run carries none); the
    kept PCM's worst LSB inside the bounds' domain and outside it, and its
    difference RMS in dBFS inside it; the worst audio RMS difference in dB
    inside the domain and outside it (where the flags agree and the
    reference is above the floor).  Then the state fields that differ; the
    measured PL tone on the carriers, where the reference records it: the
    readings (a block whose diag both runs carry, and the end) that are
    equal and those one bin away, and the run's tone after the last block
    on the carriers and on the kept noise channels (``pl_end`` None: not
    recorded); and every breach of a bound."""

    row: str
    call: str
    flags_differ: list = dataclasses.field(default_factory=list)
    lsb: list = dataclasses.field(default_factory=list)
    lsb_out: list = dataclasses.field(default_factory=list)
    pcm_rms_dbfs: list = dataclasses.field(default_factory=list)
    rms_db: list = dataclasses.field(default_factory=list)
    rms_db_out: list = dataclasses.field(default_factory=list)
    state_differ: list = dataclasses.field(default_factory=list)
    pl_equal: int = 0
    pl_one_bin: list = dataclasses.field(default_factory=list)
    pl_end: list | None = None
    pl_noise_end: list = dataclasses.field(default_factory=list)
    breaches: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.breaches

    def summary(self) -> str:
        b0 = self.flags_differ[0]
        later = sum(f for f in self.flags_differ[1:] if f >= 0)
        state = "bit-equal" if not self.state_differ else \
            "DIFFERS: " + ", ".join(self.state_differ)
        verdict = "ok" if self.ok else "BREACH: " + "; ".join(
            self.breaches[:6])
        return (f"{self.row} {self.call}: flags differ in block 0 on "
                f"{'(no diag)' if b0 < 0 else b0} channel(s), later {later};"
                f" kept PCM worst {max(self.lsb)} LSB and "
                f"{max(self.pcm_rms_dbfs):.1f} dBFS in the bounds' domain, "
                f"{max(self.lsb_out)} LSB outside it (blocks "
                f"{self.lsb_out[:3]}...); audio RMS worst "
                f"{max(self.rms_db):.4f} dB in the domain, "
                f"{max(self.rms_db_out):.4f} outside it; integer state "
                f"{state}; {self.pl_summary()}; {verdict}")

    def pl_summary(self) -> str:
        if self.pl_end is None:
            return "PL tone not recorded"
        one = len(self.pl_one_bin)
        return (f"PL tone on the carriers {self.pl_equal} reading(s) equal, "
                f"{one} one bin away"
                + (f" ({', '.join(self.pl_one_bin[:4])})" if one else "")
                + f", after the last block {_hz(self.pl_end)} Hz (noise "
                f"channels {_hz(self.pl_noise_end)})")


def _hz(v) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in v) + "]"


def _dbfs(v: float) -> float:
    return 20.0 * np.log10(v) if v > 0 else -np.inf


def _worst(a: np.ndarray) -> float:
    return float(a.max()) if a.size else 0.0


def compare(ref: dict, got: dict, row: str = "", call: str = "") -> Report:
    """Hold a run (``run_port``'s arrays) against a reference (``load``)
    at the module's bounds."""
    if not np.array_equal(ref["kept"], got["kept"]):
        raise ValueError("the run kept other channels than the reference")
    if got["rms"].shape != ref["rms"].shape:
        raise ValueError(f"run {got['rms'].shape} against reference "
                         f"{ref['rms'].shape}")
    on_car = np.zeros(ref["rms"].shape[1], bool)
    on_car[ref["carriers"]] = True
    first_kept = ref["first_pcm"][ref["kept"]]
    floor = 10.0 ** (RMS_FLOOR_DBFS / 20.0)
    rep = Report(row, call)
    for b in range(ref["rms"].shape[0]):
        # the domains (module docstring): the flags every channel from
        # block 1 and the carriers in block 0; the audio from each
        # channel's first bound block
        agree = np.ones_like(on_car)
        if got["flagged"][b]:
            differ = got["flags"][b] != ref["flags"][b]
            agree = ~differ
            rep.flags_differ.append(int(differ.sum()))
            n_bad = int((differ & (on_car | (b > 0))).sum())
            if n_bad:
                rep.breaches.append(f"block {b}: flags differ on {n_bad} "
                                    f"channel(s)")
        else:
            rep.flags_differ.append(-1)
        d = np.abs(got["pcm"][b].astype(np.int64)
                   - ref["pcm"][b].astype(np.int64))
        inside = first_kept <= b
        lsb = int(_worst(d[inside]))
        rms = float(np.sqrt(np.mean(d[inside].astype(np.float64) ** 2))) \
            / 32768.0 if inside.any() else 0.0
        rep.lsb.append(lsb)
        rep.lsb_out.append(int(_worst(d[~inside])))
        rep.pcm_rms_dbfs.append(_dbfs(rms))
        if lsb > PCM_LSB:
            rep.breaches.append(f"block {b}: kept PCM {lsb} LSB")
        if rms > 10.0 ** (PCM_RMS_DBFS / 20.0):
            rep.breaches.append(f"block {b}: kept PCM difference RMS "
                                f"{_dbfs(rms):.1f} dBFS")
        r0 = ref["rms"][b].astype(np.float64)
        r1 = got["rms"][b].astype(np.float64)
        with np.errstate(divide="ignore"):
            db = np.abs(20.0 * np.log10(np.maximum(r1, 1e-30) / r0))
        seen = agree & (r0 > floor)
        inside = ref["first_rms"] <= b
        worst = _worst(db[seen & inside])
        rep.rms_db.append(worst)
        rep.rms_db_out.append(_worst(db[seen & ~inside]))
        if worst > RMS_DB:
            n = int((db[seen & inside] > RMS_DB).sum())
            rep.breaches.append(f"block {b}: audio RMS off by {worst:.4f} dB "
                                f"on {n} channel(s)")
    for k in sorted(x for x in ref if x.startswith("state.")):
        if k not in got or not np.array_equal(ref[k], got[k]):
            rep.state_differ.append(k[len("state."):])
    if rep.state_differ:
        rep.breaches.append("integer state differs: "
                            + ", ".join(rep.state_differ))
    if "plfreq_end" in ref:
        _compare_pl(ref, got, rep)
    return rep


def _compare_pl(ref: dict, got: dict, rep: Report) -> None:
    """The measured PL tone's bound (module docstring): on each carrier,
    in every block whose diag both runs carry and after the last block,
    the same bin (NaN for NaN) or one bin away."""
    if "plfreq_end" not in got:
        rep.breaches.append("the run records no PL tone")
        return
    width = float(ref["pl_bin"])
    car = _positions(ref["kept"], ref["carriers"])
    noise = np.setdiff1d(np.arange(len(ref["kept"])), car)
    reads = [(f"block {b}", got["plfreq"][b], ref["plfreq"][b])
             for b in range(len(ref["flagged"]))
             if got["flagged"][b] and ref["flagged"][b]]
    reads.append(("end", got["plfreq_end"], ref["plfreq_end"]))
    for label, g, r in reads:
        g, r = g[car].astype(np.float64), r[car].astype(np.float64)
        nan_g, nan_r = np.isnan(g), np.isnan(r)
        with np.errstate(invalid="ignore"):
            bins = np.abs(np.rint(g / width) - np.rint(r / width))
        equal = (nan_g & nan_r) | (bins == 0)
        one = ~nan_g & ~nan_r & (bins == 1)
        rep.pl_equal += int(equal.sum())
        for i in np.flatnonzero(one):
            rep.pl_one_bin.append(f"{label} ch {ref['carriers'][i]}: "
                                  f"{g[i]:.4f} against {r[i]:.4f} Hz")
        for i in np.flatnonzero(~equal & ~one):
            rep.breaches.append(f"{label}: PL tone on carrier "
                                f"{ref['carriers'][i]} {g[i]:.4f} Hz "
                                f"against {r[i]:.4f}")
    rep.pl_end = got["plfreq_end"][car].tolist()
    rep.pl_noise_end = got["plfreq_end"][noise].tolist()


def check_input(row: Row, ref: dict, x) -> None:
    """Raise if the regenerated input is not the one the reference was
    made from (then the input differs, not the port)."""
    sha = input_sha256(x)
    if sha != ref["sha256"]:
        raise ValueError(f"{row.name}: the input block's SHA-256 {sha} is "
                         f"not the reference's {ref['sha256']}: the input "
                         "differs, not the port")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="reference", description="the runner's rows through the port, "
        "against the JAX package's reference outputs")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma list of rows (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU")
    args = ap.parse_args(argv)
    dev = configure_torch(args.cpu, "reference")
    ok = True
    for name in args.rows.split(","):
        row = ROWS[name]
        ref = load(name)
        freqs, x = row_input(row)
        check_input(row, ref, x)
        for call in row.calls:
            arrays, stats = run_port(row, dev, call, x=x, freqs=freqs,
                                     timing_iters=5)
            rep = compare(ref, arrays, name, call)
            ok &= rep.ok
            ms = stats["ms"]
            print(rep.summary() + (f"; {ms:.4f} ms/block" if ms else ""),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
