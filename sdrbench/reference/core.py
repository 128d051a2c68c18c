"""The reference's shared parts: precision, the mode table, Kaiser filter
design, the overlap-save master FFT and the channelizer.

Semantics (ka9q-radio's filter.c and the bank's frequency conversion):

- a block of L wideband samples joins the previous M-1 into an N = L+M-1
  buffer whose unnormalised forward FFT is the master spectrum;
- channel c at f_c Hz takes the N_dec = N/D bins around bin
  k_c = round(f_c N / fs) (slave bin p reads master bin k_c + p for
  p <= N_dec/2, k_c + p - N_dec above), times the channel response
  (a brick wall at the decimated rate, windowed to M_dec = (M-1)/D + 1
  taps by a Kaiser window, scaled by 1/N), times the block phase
  exp(-2 pi i k_c s / N) where s = bL - (M-1) is the absolute index of
  the buffer's first sample, so the bin shift is a mix on the absolute
  time axis;
- the unnormalised inverse FFT of those bins, last L_dec = L/D samples;
- a residual mix by the part of f_c off the bin grid,
  delta = f_c/fs - k_c/N, at the decimated rate: exp(2 pi i (delta (M-1)/2
  - delta D j)) at output sample j counted from the stream's start (the
  constant term undoes the filter's group delay at the off-bin offset).

Everything is float64 here (``Prec("float64")``); the control rounds each
stage's result to bfloat16 (``Prec("bfloat16")``), the next precision
below the float32 the configurations state.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

__all__ = ["Prec", "ModeRow", "mode_row", "kaiser", "design_complex",
           "design_real", "Master", "Channels"]


class Prec:
    """The arithmetic of a reference run: float64 throughout, or (the
    control) float32 arithmetic with every stage's result rounded to
    bfloat16."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        wide = name == "float64"
        self.real = torch.float64 if wide else torch.float32
        self.cplx = torch.complex128 if wide else torch.complex64
        self.low = not wide

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as this precision stores a stage's result."""
        if not self.low:
            return x
        if x.is_complex():
            return torch.complex(x.real.to(torch.bfloat16).to(torch.float32),
                                 x.imag.to(torch.bfloat16).to(torch.float32))
        if x.is_floating_point():
            return x.to(torch.bfloat16).to(torch.float32)
        return x


@dataclass(frozen=True)
class ModeRow:
    """One row of modes.txt."""

    name: str
    demod: str
    low: float
    high: float
    shift: float
    recovery: float
    hang: float
    flat: bool
    isb: bool
    pll: bool
    square: bool
    channels: int


def mode_row(name: str) -> ModeRow:
    """The row `name` of this package's modes.txt."""
    text = (Path(__file__).with_name("modes.txt")).read_text()
    for line in text.splitlines():
        f = line.split("#", 1)[0].split()
        if not f or f[0].upper() != name.upper():
            continue
        low, high = sorted((float(f[2]), float(f[3])))
        flags = {o.lower() for o in f[8:]}
        return ModeRow(
            name=f[0].upper(), demod=f[1].upper(), low=low, high=high,
            shift=float(f[4]), recovery=abs(float(f[6])),
            hang=abs(float(f[7])), flat="flat" in flags,
            isb=bool(flags & {"isb", "conj"}),
            pll=bool(flags & {"pll", "coherent", "square"}),
            square="square" in flags,
            channels=1 if "mono" in flags else 2)
    raise KeyError(f"mode {name!r} is not in the reference's modes.txt")


def kaiser(M: int, beta: float) -> np.ndarray:
    """Kaiser window of M taps, I0(pi beta sqrt(1 - p^2)) / I0(pi beta)
    with p from -1 to 1 (filter.c's make_kaiser); the middle tap of an odd
    window is 1."""
    if M == 1:
        return np.ones(1)
    p = 2.0 * np.arange(M) / (M - 1) - 1.0
    w = np.i0(np.pi * beta * np.sqrt(np.maximum(0.0, 1.0 - p * p))) \
        / np.i0(np.pi * beta)
    if M % 2:
        w[(M - 1) // 2] = 1.0
    return w


def _window(h: np.ndarray, M: int, beta: float) -> np.ndarray:
    """The impulse h (length N, time 0 first) cut to M taps centred on
    tap M//2 and Kaiser-windowed, zero-padded back to N."""
    out = np.zeros_like(h)
    out[:M] = h[(np.arange(M) - M // 2) % h.shape[0]] * kaiser(M, beta)
    return out


def design_complex(N_dec: int, M_dec: int, low: float, high: float,
                   beta: float, gain: float) -> np.ndarray:
    """A channel response of N_dec bins: the brick wall low <= f <= high
    (cycles per decimated sample; bin n is n/N_dec, the upper half
    negative) at `gain`, windowed to M_dec taps."""
    n = np.arange(N_dec)
    f = np.where(n <= N_dec // 2, n, n - N_dec) / N_dec
    wall = np.where((f >= low) & (f <= high), gain, 0.0).astype(np.complex128)
    return np.fft.fft(_window(np.fft.ifft(wall), M_dec, beta))


def design_real(N: int, M: int, half: np.ndarray, beta: float) -> np.ndarray:
    """A real filter's response, N/2+1 bins: `half` windowed to M taps."""
    return np.fft.rfft(_window(np.fft.irfft(half.astype(np.complex128), N),
                               M, beta))


class Master:
    """The overlap-save master FFT of the wideband stream."""

    def __init__(self, L: int, M: int, device, prec: Prec):
        self.L, self.M, self.N = L, M, L + M - 1
        self.prec = prec
        self.overlap = torch.zeros(M - 1, dtype=prec.cplx, device=device)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """x: the block, (L,) complex.  Returns the N-bin spectrum."""
        buf = torch.cat([self.overlap, x.to(self.prec.cplx)])
        self.overlap = buf[self.L:]
        return self.prec.q(torch.fft.fft(buf))


def ingest_i16(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """(L, 2) int16 I/Q as complex samples at full scale 1 (divided by
    32767, radio.c)."""
    v = x.to(prec.real) / 32767.0
    return prec.q(torch.complex(v[:, 0], v[:, 1]))


def ingest_f32(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """(L, 2) float I/Q as complex samples."""
    v = x.to(prec.real)
    return prec.q(torch.complex(v[:, 0], v[:, 1]))


class Channels:
    """A set of channels of one mode at one geometry: their bin shifts,
    residual offsets and shared response, and their baseband each block.

    freqs: every channel's frequency in Hz (whole or not); `rows` the
    channels whose baseband `baseband()` returns."""

    def __init__(self, freqs, fs: float, L: int, M: int, low_hz: float,
                 high_hz: float, device, prec: Prec, beta: float = 3.0):
        self.N = N = L + M - 1
        self.D = D = round(fs / 48000.0)
        if N % D or L % D:
            raise ValueError(f"N={N} and L={L} must be multiples of D={D}")
        self.L, self.M = L, M
        self.N_dec, self.L_dec = N // D, L // D
        self.M_dec = (M - 1) // D + 1
        self.dsamprate = fs / D
        self.prec = prec
        self.device = device
        h = self.N_dec // 2
        base = np.concatenate([np.arange(h + 1), np.arange(N - h + 1, N)])
        ks, nums = [], []
        frac = [Fraction(f) / Fraction(fs) for f in freqs]
        den = int(np.lcm.reduce([x.denominator for x in frac] + [1])) * N
        for nu in frac:
            k = int(np.round(float(nu * N)))
            ks.append(k)
            nums.append(int((nu - Fraction(k, N)) * den))
        self.k = np.asarray(ks, np.int64)
        # delta = num / den exactly, in Python integers
        self.num, self.den = nums, den
        self.base = torch.as_tensor(base, device=device)
        resp = design_complex(self.N_dec, self.M_dec, low_hz / self.dsamprate,
                              high_hz / self.dsamprate, beta, 1.0 / N)
        self.resp = prec.q(torch.as_tensor(resp, device=device).to(prec.cplx))
        self.block = 0

    def _phases(self, rows: np.ndarray, b: int) -> tuple:
        """The block phase and the residual LO of `rows` in block b."""
        N, D = self.N, self.D
        s = b * self.L - (self.M - 1)
        r = [(int(self.k[c]) * s) % N for c in rows]
        phi = torch.as_tensor([-2.0 * np.pi * v / N for v in r],
                              dtype=torch.float64, device=self.device)
        j0 = b * self.L_dec
        # delta D j and delta (M-1)/2 reduced exactly, mod one cycle
        den = self.den
        a0 = [(self.num[c] * D * j0) % den / den for c in rows]
        g = [(self.num[c] * (self.M - 1)) % (2 * den) / (2 * den)
             for c in rows]
        dD = torch.as_tensor([self.num[c] * D / den for c in rows],
                             dtype=torch.float64, device=self.device)
        i = torch.arange(self.L_dec, dtype=torch.float64, device=self.device)
        cyc = (torch.as_tensor(g, dtype=torch.float64, device=self.device)
               - torch.as_tensor(a0, dtype=torch.float64,
                                 device=self.device))[:, None] \
            - dD[:, None] * i[None, :]
        lo = torch.polar(torch.ones_like(cyc), 2.0 * np.pi * cyc)
        return torch.polar(torch.ones_like(phi), phi), lo

    def baseband(self, spec: torch.Tensor, rows: np.ndarray,
                 b: int) -> torch.Tensor:
        """(len(rows), L_dec) complex baseband of `rows` in block b from
        the block's master spectrum."""
        p = self.prec
        k = torch.as_tensor(self.k[rows], device=self.device)
        idx = (self.base[None, :] + k[:, None]) % self.N
        phi, lo = self._phases(rows, b)
        f = p.q(spec[idx] * self.resp[None, :] * phi.to(p.cplx)[:, None])
        y = p.q(torch.fft.ifft(f, dim=-1) * self.N_dec)
        return p.q(y[:, self.N_dec - self.L_dec:] * lo.to(p.cplx))

    def magnitude2(self, spec: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
        """|baseband|^2 of `rows`, which no phase changes: the gather,
        response and inverse FFT alone."""
        p = self.prec
        k = torch.as_tensor(self.k[rows], device=self.device)
        idx = (self.base[None, :] + k[:, None]) % self.N
        f = p.q(spec[idx] * self.resp[None, :])
        y = p.q(torch.fft.ifft(f, dim=-1) * self.N_dec)[:, self.N_dec
                                                       - self.L_dec:]
        return y.real ** 2 + y.imag ** 2
