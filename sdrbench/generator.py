"""The traffic generator: one second of wideband I/Q made from the seed,
served as a loop of blocks.

A traffic mix (``traffic/<name>.json``) gives the loop's signals and the
way blocks are offered; a configuration gives the band and the channels.
The draw (which channels carry a signal, and each signal's offset, level,
tones and phases) comes from ``numpy.random.default_rng(seed)`` on the
host; the noise from a ``torch.Generator`` seeded alike on the device.

Every frequency in the loop is a whole number of Hz and the loop is one
second long, so the loop is built in the frequency domain: complex noise
in every 1 Hz bin of a `fs`-point spectrum, plus each signal's spectral
lines (an FM carrier's by the Jacobi-Anger expansion of its two tones),
and one inverse FFT.  The result is periodic in `fs` samples by
construction: block 49 runs into block 0 with no jump in any phase.  It
is quantised to int16 I/Q (times 32767, clipped, truncated toward zero,
as the root ``bench.py`` quantises) and copied once to the host, into
page-locked memory: the entry's upload of a block is then one DMA, where
from pageable memory CUDA stages it through a host copy, which took 4-6
ms a 31.5 MB block on an H100 host and moved from run to run.

Signals, per group mode (the traffic file's ``signals`` list, each entry a
``kind`` with its parameters):

- ``fm``: `count` of the group's channels carry an FM carrier at a whole
  offset within +-`offset_hz` of the channel's centre, a level uniform in
  `level_dbfs`, frequency-modulated by a voice-band tone (whole Hz in
  `tone_hz`, peak deviation uniform in `deviation_hz`) and by a CTCSS tone
  of the standard set rounded to whole Hz (peak deviation
  `ctcss_deviation_hz`);
- ``ssb_pair``: two tones of whole Hz in `tone_hz` above the channel's
  centre, each at `level_dbfs`;
- ``am``: a carrier at a whole offset within +-`offset_hz`, amplitude
  modulated at depth `depth` by a tone in `tone_hz`, a level in
  `level_dbfs`; the offset is drawn among those whose position on the
  carrier search's 48000/65536 Hz bin grid lies within `bin_margin` of a
  bin's centre, so the search's strongest bin is not a near tie.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["CTCSS_HZ", "Plan", "draw", "spectrum_lines", "make_loop"]

#: The standard CTCSS tones (EIA/TIA-603), Hz.
CTCSS_HZ = (67.0, 69.3, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5,
            94.8, 97.4, 100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0,
            127.3, 131.8, 136.5, 141.3, 146.2, 151.4, 156.7, 159.8, 162.2,
            165.5, 167.9, 171.3, 173.8, 177.3, 179.9, 183.5, 186.2, 189.9,
            192.8, 196.6, 199.5, 203.5, 206.5, 210.7, 218.1, 225.7, 229.1,
            233.6, 241.8, 250.3, 254.1)

#: The carrier search's bin (linear.c: 65536 points at 48 kHz), Hz.
SEARCH_BIN_HZ = 48000.0 / 65536


@dataclass
class Carrier:
    """One signal: its group, channel, and parameters (Hz, radians)."""

    group: int
    channel: int
    kind: str
    freq: int                 # carrier frequency, whole Hz
    amp: float
    phase: float
    tones: list = field(default_factory=list)   # [(Hz, index, phase)]


@dataclass
class Plan:
    fs: int
    carriers: list

    def channels(self, group: int) -> np.ndarray:
        """The channels of `group` that carry a signal, ascending."""
        return np.asarray(sorted(c.channel for c in self.carriers
                                 if c.group == group), np.int64)


def _whole(f: float) -> int:
    if abs(f - round(f)) > 1e-6:
        raise ValueError(f"channel centre {f} Hz is not a whole number of Hz")
    return int(round(f))


def draw(groups, fs: float, signals, seed: int) -> Plan:
    """The seed's draw of every signal.  groups: [(mode, freqs)]."""
    if abs(fs - round(fs)) > 1e-6:
        raise ValueError("the loop needs a whole-Hz sample rate")
    rng = np.random.default_rng(seed)
    carriers = []
    for sig in signals:
        g = next((i for i, (m, _) in enumerate(groups)
                  if m.upper() == sig["mode"].upper()), None)
        if g is None:
            continue                      # the configuration has no such group
        freqs = groups[g][1]
        chans = np.sort(rng.choice(len(freqs), sig["count"], replace=False))
        for ch in chans:
            centre = _whole(freqs[ch])
            lo_db, hi_db = sig["level_dbfs"]
            amp = 10.0 ** (rng.uniform(lo_db, hi_db) / 20.0)
            phase = rng.uniform(0, 2 * np.pi)
            t_lo, t_hi = sig["tone_hz"]
            kind = sig["kind"]
            if kind == "fm":
                off = int(rng.integers(-sig["offset_hz"], sig["offset_hz"] + 1))
                tone = int(rng.integers(t_lo, t_hi + 1))
                dev = rng.uniform(*sig["deviation_hz"])
                ctcss = float(round(rng.choice(CTCSS_HZ)))
                c = Carrier(g, int(ch), kind, centre + off, amp, phase, [
                    (tone, dev / tone, rng.uniform(0, 2 * np.pi)),
                    (int(ctcss), sig["ctcss_deviation_hz"] / ctcss,
                     rng.uniform(0, 2 * np.pi))])
            elif kind == "ssb_pair":
                a, b = rng.choice(np.arange(t_lo, t_hi + 1), 2, replace=False)
                c = Carrier(g, int(ch), kind, centre, amp, phase, [
                    (int(a), 1.0, rng.uniform(0, 2 * np.pi)),
                    (int(b), 1.0, rng.uniform(0, 2 * np.pi))])
            elif kind == "am":
                offs = np.arange(-sig["offset_hz"], sig["offset_hz"] + 1)
                pos = offs / SEARCH_BIN_HZ
                ok = offs[np.abs(pos - np.round(pos)) <= sig["bin_margin"]]
                off = int(rng.choice(ok))
                tone = int(rng.integers(t_lo, t_hi + 1))
                c = Carrier(g, int(ch), kind, centre + off, amp, phase, [
                    (tone, sig["depth"], rng.uniform(0, 2 * np.pi))])
            else:
                raise ValueError(f"unknown signal kind {kind!r}")
            carriers.append(c)
    return Plan(int(round(fs)), carriers)


def _bessel_grid(indices, size: int = 256) -> tuple:
    """exp(i sum_j b_j sin(t_j)) on the torus, as its Fourier coefficients
    (the products of J_k(b_j)): (coefficient array, per-axis orders)."""
    grids = np.meshgrid(*[2 * np.pi * np.arange(size) / size
                          for _ in indices], indexing="ij")
    e = np.exp(1j * sum(b * np.sin(t) for b, t in zip(indices, grids)))
    c = np.fft.fftn(e) / e.size
    order = np.fft.fftfreq(size, 1.0 / size).astype(np.int64)
    return c, order


def spectrum_lines(c: Carrier, fs: int, floor: float = 1e-9) -> tuple:
    """(bins, complex amplitudes) of one signal's lines in the 1 Hz grid
    of a one-second loop (amplitude as a sample's: x = sum a e^{2 pi i f t})."""
    base = c.amp * np.exp(1j * c.phase)
    if c.kind == "fm":
        coef, order = _bessel_grid([t[1] for t in c.tones])
        keep = np.abs(coef) > floor
        k, m = np.nonzero(keep)
        (f1, _, p1), (f2, _, p2) = c.tones
        ko, mo = order[k], order[m]
        freq = c.freq + ko * f1 + mo * f2
        amp = base * coef[k, m] * np.exp(1j * (ko * p1 + mo * p2))
    elif c.kind == "ssb_pair":
        freq = np.array([c.freq + t[0] for t in c.tones])
        amp = np.array([base * np.exp(1j * t[2]) for t in c.tones])
    else:                                                    # am
        f1, m, p1 = c.tones[0]
        freq = np.array([c.freq, c.freq + f1, c.freq - f1])
        amp = base * np.array([1.0, m / 2 * np.exp(1j * p1),
                               m / 2 * np.exp(-1j * p1)])
    return np.mod(freq, fs).astype(np.int64), amp


def make_loop(plan: Plan, L: int, noise_rms: float, seed: int, device,
              noise: bool = True) -> np.ndarray:
    """The loop as a host (blocks, L, 2) int16 array, made on `device`, in
    page-locked memory when that is a card.  `noise_rms` is each of I and
    Q's."""
    fs = plan.fs
    if fs % L:
        raise ValueError(f"a one-second loop of {fs} samples is not a "
                         f"whole number of {L}-sample blocks")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    spec = torch.zeros((fs, 2), dtype=torch.float32, device=dev)
    if noise:
        spec.normal_(0.0, noise_rms * np.sqrt(fs), generator=gen)
    spec = torch.view_as_complex(spec)
    bins, amps = [], []
    for c in plan.carriers:
        b, a = spectrum_lines(c, fs)
        bins.append(b)
        amps.append(a * fs)
    if bins:
        spec.index_put_(
            (torch.as_tensor(np.concatenate(bins), device=dev),),
            torch.as_tensor(np.concatenate(amps).astype(np.complex64),
                            device=dev), accumulate=True)
    x = torch.fft.ifft(spec)
    del spec
    iq = torch.view_as_real(x).mul_(32767.0).clamp_(-32768.0, 32767.0)
    del x
    q = iq.to(torch.int16)
    del iq
    if dev.type == "cuda":
        host = torch.empty(q.shape, dtype=torch.int16, pin_memory=True)
        host.copy_(q)
        out = host.numpy()
    else:
        out = q.cpu().numpy()
    del q
    return out.reshape(fs // L, L, 2)
