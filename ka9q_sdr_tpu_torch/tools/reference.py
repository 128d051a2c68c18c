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
- E1 (not a runner row): every bank mode the runner never runs, in one
  MultiBank at 20 ms with float32 ingest: AM:512 + AME:256 + DSB:256 +
  CISB:256 + ISB:256 + IQ:256 + LSB:512 + CWU:256 + CWL:256 + FMF:512
  (3,328 channels on bench.py's span, each frequency rounded to the
  50 Hz that a 20 ms block holds whole cycles of), bench_inputs' noise and
  on each group's middle channel the carrier of its mode's signal
  (``MODE_SIGNALS``, ``mode_input``); K = 36, so that the PLL modes'
  first acquisition (block 34 for DSB's squared ring, 35 for the others)
  lies inside the row; ``MultiBank.process``.  It keeps the carriers'
  PCM alone (both ears of a stereo mode) in blocks 0-3 and 32-35, and
  each carrier's audio tone in each ear (``TONE_BLOCKS``).
- S1 (not a runner row): README's mesh deployment, ``bankd -r 393216000
  --channels 4094 -m FM --max-active 64 --mesh 4 --shard-fft``: FM (no
  PL) 4094 ch at 20 ms, bench_inputs' block at 4094 channels, padded to
  4096 over a 4-shard mesh with the distributed master FFT; K = 24;
  ``process_i16_pcm``, ``process_scan_i16(pcm_out=True)`` in chunks of 8
  (replicated, as the JAX package compiles a mesh scan), and
  ``process_active(64, n_valid=4094)`` (replicated too), whose
  run the file keeps beside the step's (keys ``active.*``).

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
block from the state, with the width of a PL bin; the PCM of a stereo
mode's kept channel ear by ear (``ears``: 1 or 2 a kept channel, its rows
laid out channel by channel); where a row keeps PCM only in some blocks,
those blocks (``pcm_blocks``); where the carriers carry a mode's signal
(E1), each carrier's audio tone in each ear, the bin of the largest peak
of an rFFT of its last ``TONE_BLOCKS`` blocks of PCM (``tone``, -1 for
no second ear, with the bin's width); for an ``active`` run the active
set of every block (``idx``, -1 an unused slot), the PCM of the rows it
returned placed on their channels and zeros elsewhere; and metadata (the
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
  channel's tone (a peak of noise) is only printed;
- the audio tone of each carrier that carries a mode's signal, in each
  ear: the reference's bin or the next (the same near-tie);
- an ``active`` run's active set (these bounds were set before the
  row's first run): no mesh-padding row in it, and in each block equal to
  the reference's on the channels whose audio that block binds (``first_
  rms``): the set is the top of the audio peaks, so it is bound where the
  audio is; the channels that differ outside that domain are printed.

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
thresholds are unchanged.  The domain also ends: a noise channel of a
mode whose hang AGC holds its gain for 0 < hangmax samples, fewer than
the row spans (CWU and CWL: 0.2 s, 10 blocks at 20 ms), is bound up to
block ``hangmax // L_dec`` (``last_bound``).  A row repeats one block,
so from block 2 on such a channel's envelope repeats each block, and
each re-clamp of the AGC at the block's peak is an exact tie of two
equal samples that float32 rounding decides; where the two runs decide
it apart, the hang ends in different blocks and the gain recovers
(20 dB/s) from different samples.  E1's first run found it on the CPU
port (up to 0.2181 dB on 202 of CWU's and 202 of CWL's 255 noise
channels, blocks 11-35, none before), and the port against itself with
its master FFT taken by ``fft_fourstep`` (another exact float32 FFT)
shows it alike (0.2047 dB at N = 65536 from block 11, tests/
test_torch_reference.py ``test_cw_hang_tie_is_the_inputs``), so the
domain ends where a tie can first move the hang; the thresholds are
unchanged.  Every figure outside the domain is printed.

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
from ..ops.agc import AGCParams
from ..parallel.mesh import gather_bank_state, make_channel_mesh, \
    pad_channels
from ..utils.modes import DEFAULT_MODES
from ..utils.runtime import configure_torch
from ..utils.timing import cuda_ms

__all__ = ["Row", "ROWS", "REF_DIR", "SCAN_CHUNK", "N_NOISE", "PCM_LSB",
           "PCM_RMS_DBFS", "RMS_DB", "RMS_FLOOR_DBFS", "PL_TOL_HZ",
           "M1_TONES", "MODE_SIGNALS", "TONE_BLOCKS", "MAX_ACTIVE",
           "row_input", "bench_noise", "quantise_i16", "modulated_input",
           "mode_input", "fm_phase", "input_sha256", "carrier_channels",
           "kept_channels", "pcm_blocks", "first_bound", "last_bound",
           "pl_bin",
           "pl_firings", "tone_bin", "Record", "int_state", "diag_flags",
           "plfreq_of", "check_pl_tones", "check_tones", "save", "load",
           "for_call", "check_input", "row_mesh", "run_port", "Report",
           "compare", "main"]

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
#: blocks of a carrier's PCM whose rFFT gives its audio tone
TONE_BLOCKS = 8
#: an active call's slots (bankd --max-active 64)
MAX_ACTIVE = 64

_BANK_FIELDS = ("k", "r", "dr")
_NCO_FIELDS = ("phase", "freq")
_DEMOD_FIELDS = ("pl_counter", "lock_count", "fft_samples", "pll_lock")


@dataclasses.dataclass(frozen=True)
class Row:
    """One row: a bank (``mode``) or a MultiBank (``groups``) at a
    geometry, K blocks, and the port's call plans ("step": one block a
    call; "scan": ``process_scan_i16(pcm_out=True)`` in chunks of
    SCAN_CHUNK, the rest one block a call; "active": ``process_active``
    with ``max_active`` slots, one block a call).  ``tones``, one a carrier:
    (voice Hz, its peak deviation Hz, PL Hz, its peak deviation Hz); a
    row with tones takes ``modulated_input``, and a row with ``signals``
    ``mode_input``: neither is a runner row.  ``mesh``: (shards,
    shard_fft), the bank's frequencies padded to a multiple of the shards.
    ``kept``: "near" (each carrier, its neighbours and N_NOISE noise
    channels) or "carriers"; ``pcm_blocks``: the blocks whose kept PCM the
    record holds (all where empty)."""

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
    signals: bool = False
    mesh: tuple = ()
    kept: str = "near"
    pcm_blocks: tuple = ()
    max_active: int = MAX_ACTIVE

    @property
    def total(self) -> int:
        return sum(n for _, n in self.groups) if self.groups else \
            self.n_channels

    def geometry(self) -> dict:
        """What a reference file records of the row (JSON-ready)."""
        out = {"mode": self.mode, "n_channels": self.total,
               "groups": [list(g) for g in self.groups],
               "samprate": self.samprate, "L": self.L, "M": self.M,
               "cfg": dict(self.cfg)}
        if self.mesh:
            out["mesh"] = list(self.mesh)
        if self.signals:
            out["signals"] = {m: [list(p) for p in MODE_SIGNALS[m][0]]
                              + [list(MODE_SIGNALS[m][1] or ())]
                              for m, _ in self.groups}
        return out


_FS = 393.216e6
_L20, _M20 = 7864320, 8912897
_LONG = 58195968
_PL = (("enable_pl", True),)
#: M1's carriers, on channels 3, n/2 and n-5: a voice-band tone at 3 kHz
#: and a PL tone at 500 Hz peak deviation each
M1_TONES = ((1000, 3000, 100, 500), (1500, 3000, 150, 500),
            (700, 3000, 200, 500))
#: each mode's signal on its carrier at fc: the parts (amplitude, offset
#: Hz from fc) of its spectrum, the FM modulation of the carrier (tone Hz,
#: its peak deviation Hz) or None, and the audio tone it gives in each ear
#: (Hz).  AM, AME and CISB: AM by a 1 kHz tone at m = 0.5; DSB: its
#: suppressed-carrier sidebands; LSB: a tone 1 kHz below fc; CWU and CWL: a
#: bare carrier, the mode's 700 Hz pitch; ISB: 1.5 kHz below fc (left ear)
#: and 1 kHz above (right); IQ: fc + 1 kHz in both; FMF: FM by a 1 kHz
#: tone at 3 kHz peak deviation, no de-emphasis
_AM = ((0.2, 0), (0.05, 1000), (0.05, -1000))
MODE_SIGNALS = {
    "AM": (_AM, None, (1000,)),
    "AME": (_AM, None, (1000,)),
    "CISB": (_AM, None, (1000, 1000)),
    "DSB": (((0.1, 1000), (0.1, -1000)), None, (1000,)),
    "LSB": (((0.2, -1000),), None, (1000,)),
    "CWU": (((0.2, 0),), None, (700,)),
    "CWL": (((0.2, 0),), None, (700,)),
    "ISB": (((0.2, -1500), (0.2, 1000)), None, (1500, 1000)),
    "IQ": (((0.2, 1000),), None, (1000, 1000)),
    "FMF": (((0.2, 0),), (1000, 3000), (1000,)),
}
_E1_GROUPS = (("AM", 512), ("AME", 256), ("DSB", 256), ("CISB", 256),
              ("ISB", 256), ("IQ", 256), ("LSB", 512), ("CWU", 256),
              ("CWL", 256), ("FMF", 512))
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
    Row("E1", "MultiBank of every mode the runner never runs, 20 ms, each "
        "carrier its mode's signal", _FS, _L20, _M20, 36, groups=_E1_GROUPS,
        signals=True, kept="carriers", pcm_blocks=(0, 1, 2, 3, 32, 33, 34,
                                                   35)),
    Row("S1", "FM 4094 ch 20 ms on a 4-shard shard_fft mesh (README's "
        "bankd --mesh 4 --shard-fft)", _FS, _L20, _M20, 24, mode="FM",
        n_channels=4094, calls=("step", "scan", "active"), mesh=(4, True)),
)}


def row_input(row: Row):
    """The row's frequencies (a list, or the MultiBank's groups) and its
    one input block: (L, 2) int16 for a bank, (L, 2) float32 for the
    MultiBank."""
    if row.signals:
        return mode_input(row)
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
    instantaneous frequency fc + da cos(2 pi fa t) + dp cos(2 pi fp t);
    `tone` is (fa, da, fp, dp), or (fa, da) for one tone.  Every frequency
    makes whole cycles in a block (``_cycles``), so the block repeated is
    one continuous signal."""
    two_pi = 2.0 * np.pi
    ph = two_pi * _cycles(fc, n, fs, L)
    for fa, da in zip(tone[::2], tone[1::2]):
        ph = ph + (da / fa) * np.sin(two_pi * _cycles(fa, n, fs, L))
    return ph


def modulated_input(row: Row):
    """A modulated row's frequencies and (L, 2) int16 block: bench_inputs'
    channels and noise, with a 0.2 carrier on each carrier channel
    FM-modulated by the row's tones (``fm_phase``)."""
    fs, L = _whole_hz(row)
    usable = 0.9 * row.samprate
    freqs = list(np.linspace(-usable / 2, usable / 2, row.n_channels,
                             endpoint=False))
    n = np.arange(L, dtype=np.int64)
    x = bench_noise(L)
    for ch, tone in zip(carrier_channels(row), row.tones, strict=True):
        x += 0.2 * np.exp(1j * fm_phase(freqs[ch], tone, n, fs, L))
    return freqs, quantise_i16(x)


def _whole_hz(row: Row) -> tuple:
    fs = int(row.samprate)
    if fs != row.samprate:
        raise ValueError(f"{row.samprate} Hz is no whole number of Hz")
    return fs, row.L


def mode_input(row: Row):
    """A row with ``signals``: its MultiBank groups and (L, 2) float32
    block.  The channels lie on bench.py's span (mixed_inputs) with each
    frequency rounded to a multiple of fs / L, the rate whose every
    multiple makes whole cycles in a block (50 Hz at 20 ms); the block is
    bench_inputs' noise plus, on each group's middle channel, the carrier
    of its mode's signal (``MODE_SIGNALS``) in closed form, so that the
    block repeated is one continuous signal."""
    fs, L = _whole_hz(row)
    if fs % L:
        raise ValueError(f"a block of {L} samples at {fs} Hz holds whole "
                         "cycles of no whole-Hz grid")
    grid = fs // L
    usable = 0.9 * row.samprate
    all_freqs = np.linspace(-usable / 2, usable / 2, row.total,
                            endpoint=False)
    all_freqs = grid * np.round(all_freqs / grid)
    n = np.arange(L, dtype=np.int64)
    x = bench_noise(L)
    groups, i = [], 0
    for mode, k in row.groups:
        freqs = list(all_freqs[i:i + k])
        groups.append((mode, freqs))
        i += k
        fc = freqs[k // 2]
        parts, fm, _ = MODE_SIGNALS[mode]
        for amp, off in parts:
            ph = fm_phase(fc + off, fm, n, fs, L) if fm else \
                2.0 * np.pi * _cycles(fc + off, n, fs, L)
            x += amp * np.exp(1j * ph)
    x_r = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return groups, x_r


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
    noise channels, each the free channel nearest an evenly spaced mark;
    the carriers alone where the row keeps only them."""
    if row.kept == "carriers":
        return np.asarray(carrier_channels(row), np.int64)
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


def pcm_blocks(row: Row) -> np.ndarray:
    """The blocks whose kept PCM a record holds."""
    return np.asarray(row.pcm_blocks or range(row.K), np.int64)


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
    1 + lag and 1 + lag.  FM is every mode of the FM demodulator (FM and
    FMF)."""
    decimate = _decimate(row)
    L_dec, M_dec = row.L // decimate, (row.M - 1) // decimate + 1
    lag = -(-(M_dec - 1) // L_dec)
    modes = _modes(row)
    fm = np.asarray([DEFAULT_MODES[m].demod == "FM" for m in modes])
    carrier = np.zeros(len(modes), bool)
    carrier[carrier_channels(row)] = True
    noise = np.where(fm, 1 + lag, 1)
    first_pcm = np.where(carrier, np.where(fm, 0, 1), noise)
    first_rms = np.where(carrier, 0, noise)
    return first_pcm.astype(np.int8), first_rms.astype(np.int8)


def last_bound(row: Row) -> np.ndarray:
    """Each channel's last block whose audio the bounds hold, (B,) int16
    (module docstring): K - 1, but for a noise channel of a mode whose
    hang AGC holds its gain 0 < hangmax samples, fewer than the row
    spans, hangmax // L_dec (CWU and CWL at 20 ms: block 10)."""
    L_dec = row.L // _decimate(row)
    samptime = 1.0 / (row.samprate / _decimate(row))
    modes = _modes(row)
    last = np.full(len(modes), row.K - 1, np.int64)
    for c, m in enumerate(modes):
        mode = DEFAULT_MODES[m]
        # the AGC's own hangmax (make_bank_config's derivation)
        hangmax = AGCParams.from_mode(0.0, 0.0, mode.hangtime,
                                      samptime).hangmax
        if mode.demod != "FM" and 0 < hangmax and hangmax // L_dec < \
                row.K - 1:
            last[c] = hangmax // L_dec
    last[carrier_channels(row)] = row.K - 1
    return last.astype(np.int16)


def _modes(row: Row) -> list:
    """Each channel's mode."""
    return [m for m, n in row.groups for _ in range(n)] if row.groups \
        else [row.mode] * row.n_channels


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


def tone_bin(row: Row) -> float:
    """The width in Hz of a bin of the audio tone's rFFT: the 48 kHz
    output rate over TONE_BLOCKS blocks of L_dec samples."""
    return 48000.0 / (TONE_BLOCKS * (row.L // _decimate(row)))


def _peak_bin(pcm: np.ndarray) -> int:
    """The bin of the largest peak of the rFFT of (T,) PCM, DC left out
    (tests/test_torch_bank_modes.py ``_tone_hz``)."""
    spec = np.abs(np.fft.rfft(pcm.astype(np.float64)))
    spec[0] = 0.0
    return int(np.argmax(spec))


def check_tones(row: Row, arrays: dict) -> str:
    """A row with ``signals``: its input check, not a bound on the port.
    Each carrier's audio tone, in each ear, lies within one bin of the
    tone its mode's signal gives (``MODE_SIGNALS``).  Raises if not;
    returns what it read."""
    width = float(arrays["tone_bin"])
    got = arrays["tone"]
    out = []
    for i, (mode, _) in enumerate(row.groups):
        want = np.asarray(MODE_SIGNALS[mode][2], np.float64) / width
        have = got[i, :len(want)]
        if np.any(np.abs(have - want) > 1) or np.any(got[i, len(want):]
                                                     >= 0):
            raise ValueError(f"{row.name}: the {mode} carrier's audio tone "
                             f"{(have * width).tolist()} Hz is not within "
                             f"one bin ({width} Hz) of "
                             f"{MODE_SIGNALS[mode][2]} Hz")
        out.append(f"{mode} {'/'.join(f'{v * width:g}' for v in have)}")
    return ", ".join(out) + " Hz"


class Record:
    """What a run of a row leaves: per block the flags (or none, for a
    block of a scan), the RMS of every channel, the kept channels' PCM (in
    the kept blocks, ear by ear) and measured PL tone, the active set of
    an active run; then the integer state and the PL tone it holds, and
    the carriers' audio tone where they carry a mode's signal."""

    def __init__(self, row: Row):
        self.row = row
        self.kept = kept_channels(row)
        self.first_pcm, self.first_rms = first_bound(row)
        self.last = last_bound(row)
        self.pcm_blocks = set(pcm_blocks(row).tolist())
        self.flags, self.flagged, self.rms, self.pcm = [], [], [], []
        self.plfreq, self.idx, self.ears, self.car = [], [], None, []

    def add(self, out, flags=None, plfreq=None) -> None:
        """One block: out (B, L_dec[, 2]) int16 PCM or float audio (or a
        list of them, one a group in order), flags (B,) and plfreq (B,) or
        None (a block of a scan), on the host or the device.  Rows past the
        row's channels (mesh padding) are dropped."""
        outs = [_np(o) for o in (out if isinstance(out, list) else [out])]
        n = self.row.total
        if len(outs) == 1:
            outs = [outs[0][:n]]
        self.rms.append(np.concatenate([_rms(o) for o in outs]))
        rows = self._rows(outs, self.kept)
        if self.ears is None:
            self.ears = np.asarray([len(r) for r in rows], np.int8)
        if len(self.flagged) in self.pcm_blocks:
            self.pcm.append(np.stack([e for r in rows for e in r]))
        if self.row.signals:
            self.car = (self.car + [self._rows(
                outs, carrier_channels(self.row))])[-TONE_BLOCKS:]
        self.flagged.append(flags is not None)
        self.flags.append(np.zeros(n, bool) if flags is None
                          else _np(flags).astype(bool)[:n])
        self.plfreq.append(np.full(len(self.kept), np.nan, np.float32)
                           if plfreq is None else
                           _np(plfreq).astype(np.float32)[self.kept])

    @staticmethod
    def _rows(outs, channels) -> list:
        """Each of `channels` as a list of its int16 PCM ears."""
        ends = np.cumsum([len(o) for o in outs])
        got = []
        for c in np.asarray(channels).tolist():
            g = int(np.searchsorted(ends, c, side="right"))
            a = outs[g][c - (ends[g] - len(outs[g]))]
            a = a if a.dtype == np.int16 else scaleclip_int16(a)
            got.append([a] if a.ndim == 1 else [a[:, e] for e in
                                                range(a.shape[1])])
        return got

    def add_diag(self, out, diag) -> None:
        """One block of a bank: its output and its diag."""
        self.add(out, _flags(diag, len(out)), diag.get("plfreq"))

    def add_groups(self, outs) -> None:
        """One block of a MultiBank: [(audio, diag), ...] a group."""
        self.add([_np(a) for a, _ in outs],
                 np.concatenate([_flags(d, len(a)) for a, d in outs]),
                 plfreq_of([(d.get("plfreq"), len(a)) for a, d in outs]))

    def add_active(self, pcm, idx, diag) -> None:
        """One block of an active call: the (max_active, L_dec) PCM rows
        placed on their channels (idx, -1 an unused slot; a row past the
        row's channels, mesh padding, is kept in idx alone)."""
        pcm, idx = _np(pcm), _np(idx).astype(np.int64)
        full = np.zeros((self.row.total,) + pcm.shape[1:], pcm.dtype)
        ok = (idx >= 0) & (idx < self.row.total)
        full[idx[ok]] = pcm[ok]
        self.idx.append(idx)
        self.add_diag(full, diag)

    def arrays(self, states) -> dict:
        d = {"flags": np.stack(self.flags), "flagged": np.asarray(
            self.flagged), "rms": np.stack(self.rms), "pcm": np.stack(
                self.pcm), "kept": self.kept, "first_pcm": self.first_pcm,
             "first_rms": self.first_rms, "carriers": np.asarray(
                    carrier_channels(self.row), np.int64)}
        if np.any(self.ears > 1):
            d["ears"] = self.ears
        if np.any(self.last < self.row.K - 1):
            d["last_bound"] = self.last
        if self.row.pcm_blocks:
            d["pcm_blocks"] = pcm_blocks(self.row)
        if self.idx:
            d["idx"] = np.stack(self.idx)
        if self.row.signals:
            if len(self.car) < TONE_BLOCKS:
                raise ValueError(f"{self.row.name}: {len(self.car)} blocks "
                                 f"give no tone of {TONE_BLOCKS}")
            tone = np.full((len(self.car[0]), 2), -1, np.int64)
            for i, ears in enumerate(zip(*self.car)):
                for e, parts in enumerate(zip(*ears)):
                    tone[i, e] = _peak_bin(np.concatenate(parts))
            d.update(tone=tone, tone_bin=np.float64(tone_bin(self.row)))
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


def for_call(ref: dict, call: str) -> dict:
    """The reference a call of the row is held to: an active call's own run
    (the keys ``active.*``) where the file keeps one, else the step's."""
    pre = "active."
    if call != "active" or not any(k.startswith(pre) for k in ref):
        return ref
    out = {k: v for k, v in ref.items() if not k.startswith(pre)
           and not k.startswith("state.")}
    out.update({k[len(pre):]: v for k, v in ref.items()
                if k.startswith(pre)})
    return out


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

def row_mesh(row: Row, device, cards: bool = False):
    """The row's mesh: its shards on `device` (a card stands in for as many
    cards as the row has shards), CPU shards on the CPU, or with `cards`
    the first cards of the machine, one a shard."""
    n = row.mesh[0]
    if device.type == "cpu":
        return make_channel_mesh(n, cpu=True)
    return make_channel_mesh(n) if cards else \
        make_channel_mesh(devices=[device] * n)


def run_port(row: Row, device, call: str = "step", x=None, freqs=None,
             timing_iters: int = 0, cards: bool = False):
    """The row through the port's bank on `device` by the call plan `call`
    (a mesh row: on ``row_mesh(row, device, cards)``).  x / freqs: the
    row's input, if the caller made it already.

    Returns (record arrays, stats): stats["launches"] the fill and AGC
    kernel launches and stats["replays"] the graph replays over the checked
    blocks; stats["ms"], with timing_iters on a card, the device ms a block
    by CUDA events around that many more calls of the plan's unit (one
    block, or a chunk of SCAN_CHUNK) after them, else None."""
    if call not in ("step", "scan", "active") or (
            row.groups and call != "step"):
        raise ValueError(f"{row.name}: no {call!r} plan")
    device = torch.device(device)
    if x is None:
        freqs, x = row_input(row)
    out = _drive(row, device, call, x, freqs, timing_iters, cards)
    gc.collect()              # the wrapper's graphs and pools, before the
    if device.type == "cuda":  # next row captures its own
        torch.cuda.empty_cache()
    return out


def _drive(row, device, call, x, freqs, timing_iters, cards):
    rec = Record(row)
    if row.groups:
        wrapper = MultiBank(freqs, samprate=row.samprate, L=row.L, M=row.M,
                            device=device, **dict(row.cfg))

        def one():
            return (wrapper.process(x_dev),)
        add = rec.add_groups
    else:
        mesh = row_mesh(row, device, cards) if row.mesh else None
        if mesh is not None:
            freqs = pad_channels(freqs, mesh.size)
            device = mesh.devices[0]
        cfg = make_bank_config(len(freqs), row.mode, samprate=row.samprate,
                               L=row.L, M=row.M, **dict(row.cfg))
        wrapper = ChannelBank(cfg, freqs, device=None if mesh else device,
                              mesh=mesh, shard_fft=bool(mesh)
                              and row.mesh[1])
        n_valid = row.total if len(freqs) != row.total else None

        def one():
            if call == "active":
                return wrapper.process_active(x_dev, row.max_active,
                                              n_valid)
            return wrapper.process_i16_pcm(x_dev)
        add = rec.add_active if call == "active" else rec.add_diag
    x_dev = torch.as_tensor(x, device=device)
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
    arrays = rec.arrays(wrapper.states if row.groups else [
        gather_bank_state(wrapper.state) if row.mesh else wrapper.state])
    if timing_iters and device.type == "cuda":
        stats["ms"] = cuda_ms(unit, timing_iters) / n_unit
    return arrays, stats


def diag_flags(diag):
    """The flag a diag carries: the FM demodulator's ``squelch_open`` (FM,
    FMF), the linear demodulator's ``pll_lock`` (false on every channel of
    a mode without a PLL: USB, LSB, CWU, CWL, IQ, ISB); None for the AM
    demodulator's, which carries no flag (``bb_power`` and ``gain``)."""
    for key in ("squelch_open", "pll_lock"):
        if key in diag:
            return diag[key]
    return None


def _flags(diag, n: int) -> np.ndarray:
    f = diag_flags(diag)
    return np.zeros(n, bool) if f is None else _np(f).astype(bool)


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
    recorded); the carriers' audio tones, where the reference records
    them: the run's, in Hz a carrier and ear (``tones`` None: not
    recorded), and those one bin from the reference's; an active run's
    channels whose place in the active set differs from the reference's,
    per block, inside the bound's domain and outside it (empty: no active
    set); and every breach of a bound."""

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
    tones: list | None = None
    tone_one_bin: list = dataclasses.field(default_factory=list)
    active_differ: list = dataclasses.field(default_factory=list)
    active_out: list = dataclasses.field(default_factory=list)
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
                f"{state}; {self.pl_summary()}"
                + "".join(f"; {x}" for x in (self.tone_summary(),
                                             self.active_summary()) if x)
                + f"; {verdict}")

    def tone_summary(self) -> str:
        if self.tones is None:
            return ""
        one = len(self.tone_one_bin)
        return ("carriers' audio tones " + ", ".join(
            "/".join(f"{v:g}" for v in t) for t in self.tones)
            + f" Hz, {one} one bin away"
            + (f" ({', '.join(self.tone_one_bin[:4])})" if one else ""))

    def active_summary(self) -> str:
        if not self.active_differ:
            return ""
        return (f"active sets differ in the domain on "
                f"{sum(self.active_differ)} channel(s), outside it on "
                f"{sum(self.active_out)} (blocks {self.active_out[:4]}...)")

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
    """Hold a run (``run_port``'s arrays) against a reference (``load``;
    ``for_call`` picks an active call's own) at the module's bounds."""
    ref = for_call(ref, call)
    if not np.array_equal(ref["kept"], got["kept"]):
        raise ValueError("the run kept other channels than the reference")
    if got["rms"].shape != ref["rms"].shape or \
            got["pcm"].shape != ref["pcm"].shape:
        raise ValueError(f"run {got['rms'].shape} {got['pcm'].shape} "
                         f"against reference {ref['rms'].shape} "
                         f"{ref['pcm'].shape}")
    K = ref["rms"].shape[0]
    on_car = np.zeros(ref["rms"].shape[1], bool)
    on_car[ref["carriers"]] = True
    # one PCM row an ear of a kept channel
    ears = ref.get("ears", 1)
    last = ref.get("last_bound", np.full(ref["rms"].shape[1], K - 1))
    first_kept = np.repeat(ref["first_pcm"][ref["kept"]], ears)
    last_kept = np.repeat(last[ref["kept"]], ears)
    kept_blocks = ref.get("pcm_blocks", np.arange(K)).tolist()
    floor = 10.0 ** (RMS_FLOOR_DBFS / 20.0)
    rep = Report(row, call)
    for b in range(K):
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
        if b in kept_blocks:
            j = kept_blocks.index(b)
            d = np.abs(got["pcm"][j].astype(np.int64)
                       - ref["pcm"][j].astype(np.int64))
            inside = (first_kept <= b) & (b <= last_kept)
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
        inside = (ref["first_rms"] <= b) & (b <= last)
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
    if "tone" in ref:
        _compare_tones(ref, got, rep)
    if "idx" in ref:
        _compare_active(ref, got, rep)
    return rep


def _compare_tones(ref: dict, got: dict, rep: Report) -> None:
    """Each carrier's audio tone in each ear: the reference's bin or the
    next."""
    if "tone" not in got:
        rep.breaches.append("the run records no audio tone")
        return
    width = float(ref["tone_bin"])
    rep.tones = [[float(v * width) for v in t if v >= 0] for t in got["tone"]]
    for i, (g, r) in enumerate(zip(got["tone"], ref["tone"])):
        for e in range(len(r)):
            label = f"ch {ref['carriers'][i]} ear {e}: {g[e] * width:g} " \
                f"against {r[e] * width:g} Hz"
            if (g[e] < 0) != (r[e] < 0) or abs(int(g[e]) - int(r[e])) > 1:
                rep.breaches.append(f"audio tone on {label}")
            elif g[e] != r[e]:
                rep.tone_one_bin.append(label)


def _compare_active(ref: dict, got: dict, rep: Report) -> None:
    """An active run's sets: no padding row, and equal to the reference's
    in each block on the channels whose audio the block binds."""
    if "idx" not in got:
        rep.breaches.append("the run records no active set")
        return
    n = ref["rms"].shape[1]
    last = ref.get("last_bound", np.full(n, len(ref["idx"]) - 1))
    for b, (g, r) in enumerate(zip(got["idx"], ref["idx"])):
        pad = sorted(int(i) for i in g if i >= n)
        if pad:
            rep.breaches.append(f"block {b}: padding row(s) {pad[:4]} in "
                                f"the active set")
        mark = np.zeros((2, n), bool)
        mark[0, g[(g >= 0) & (g < n)]] = True
        mark[1, r[(r >= 0) & (r < n)]] = True
        differ = mark[0] != mark[1]
        inside = (ref["first_rms"] <= b) & (b <= last)
        rep.active_differ.append(int((differ & inside).sum()))
        rep.active_out.append(int((differ & ~inside).sum()))
        if rep.active_differ[-1]:
            rep.breaches.append(f"block {b}: the active set differs on "
                                f"{rep.active_differ[-1]} channel(s)")


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
