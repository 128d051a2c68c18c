"""Kaiser-window filter design for the overlap-save fast-convolution engine.

Design-time math runs on the host in float64 numpy (it happens only on
retune/reconfigure, never in the per-block hot loop) and produces complex64
frequency responses that are uploaded to the device.

This is the PyTorch port's own copy of ``ka9q_sdr_tpu.ops.window``: the
original is numpy-only, but importing it runs ``ka9q_sdr_tpu.ops``'s
package init, which imports jax.  The tests hold the two bit-exact.

Semantics match the reference implementation:
- make_kaiser / i0:      filter.c:282-357
- window_filter:         filter.c:365-415  (complex response, length N)
- window_rfilter:        filter.c:420-469  (real-signal response, N/2+1 bins)
- brickwall_response:    set_filter() response construction, filter.c:500-536
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "i0",
    "make_kaiser",
    "window_filter",
    "window_rfilter",
    "brickwall_response",
    "design_bandpass",
]

#: Default Kaiser window shape factor (filter.c:279).
KAISER_BETA_DEFAULT = 3.0


def i0(x: np.ndarray | float) -> np.ndarray:
    """Modified Bessel function of the first kind, order zero.

    The reference uses a truncated power series (filter.c:282-293); we use
    numpy's float64 implementation, which agrees to well below the float32
    resolution of the reference.
    """
    return np.i0(x)


def make_kaiser(M: int, beta: float) -> np.ndarray:
    """Kaiser window of length M with shape parameter beta (filter.c:337-357).

    Symmetric; for odd M the middle value is exactly 1.
    """
    if M < 1:
        raise ValueError("window length must be >= 1")
    if M == 1:
        return np.ones(1)
    n = np.arange(M, dtype=np.float64)
    p = 2.0 * n / (M - 1) - 1.0
    # Guard tiny negative values from rounding before the sqrt.
    w = i0(np.pi * beta * np.sqrt(np.maximum(0.0, 1.0 - p * p))) / i0(np.pi * beta)
    if M & 1:
        w[(M - 1) // 2] = 1.0
    return w


def _windowed_impulse(h: np.ndarray, M: int, beta: float) -> np.ndarray:
    """Shift an impulse response to be causal, Kaiser-window it to M taps,
    and zero-pad back to full length (the core of filter.c:388-392)."""
    N = h.shape[0]
    w = make_kaiser(M, beta)
    out = np.zeros_like(h)
    idx = (np.arange(M) - M // 2) % N
    out[:M] = h[idx] * w
    return out


def window_filter(L: int, M: int, response: np.ndarray, beta: float) -> np.ndarray:
    """Kaiser-window a complex frequency response in place (filter.c:365-415).

    `response` has length N = L + M - 1 and is in FFT bin order (DC first,
    negative frequencies in the top half).  The impulse response is limited
    to M taps, centred (linear phase about M/2), and transformed back.

    The reference's FFTW round trip scales by N and then multiplies by 1/N;
    numpy's ifft/fft pair is already unity-gain, so no extra factor appears.
    """
    N = L + M - 1
    if response.shape[0] != N:
        raise ValueError(f"response length {response.shape[0]} != L+M-1 = {N}")
    h = np.fft.ifft(response.astype(np.complex128))
    return np.fft.fft(_windowed_impulse(h, M, beta))


def window_rfilter(L: int, M: int, response: np.ndarray, beta: float) -> np.ndarray:
    """Real-signal counterpart of window_filter (filter.c:420-469).

    `response` holds only DC..Nyquist (N/2+1 bins); negative frequencies are
    implicitly conjugate-symmetric.
    """
    N = L + M - 1
    if response.shape[0] != N // 2 + 1:
        raise ValueError(f"response length {response.shape[0]} != N/2+1 = {N // 2 + 1}")
    h = np.fft.irfft(response.astype(np.complex128), N)
    return np.fft.rfft(_windowed_impulse(h, M, beta))


def brickwall_response(
    N_dec: int, low: float, high: float, gain: float
) -> np.ndarray:
    """Ideal brick-wall bandpass in FFT bin order (set_filter, filter.c:525-535).

    low/high are in cycles/sample at the (decimated) output rate, in
    [-0.5, 0.5].  Bin n maps to f = n/N_dec for n <= N_dec/2 and
    (n - N_dec)/N_dec above; bins with low <= f <= high get `gain`.
    """
    n = np.arange(N_dec)
    f = np.where(n <= N_dec // 2, n, n - N_dec) / N_dec
    return np.where((f >= low) & (f <= high), gain, 0.0).astype(np.complex128)


def design_bandpass(
    L: int,
    M: int,
    decimate: int,
    low: float,
    high: float,
    beta: float = KAISER_BETA_DEFAULT,
    *,
    real_output: bool = False,
    cross_conj: bool = False,
) -> np.ndarray:
    """Full set_filter() design path (filter.c:500-546).

    Builds the complex frequency response for a slave filter attached to a
    master with input block L, impulse length M, at the given decimation.
    low/high are in cycles/sample of the *decimated* output rate.

    Gain bookkeeping matches the reference exactly: 1/N for the forward
    FFT's missing normalisation (filter.c:518), times sqrt(1/2) for REAL or
    CROSS_CONJ outputs (filter.c:520-522).

    Returns the response as complex64, length N_dec = (L+M-1)/decimate.
    """
    if not (abs(low) <= 0.5 and abs(high) <= 0.5):
        raise ValueError("band edges must be within +/- 0.5 cycles/sample")
    N = L + M - 1
    if N % decimate:
        raise ValueError(f"FFT size {N} not divisible by decimation {decimate}")
    L_dec = L // decimate
    M_dec = (M - 1) // decimate + 1
    N_dec = L_dec + M_dec - 1
    gain = 1.0 / N
    if real_output or cross_conj:
        gain *= np.sqrt(0.5)
    resp = brickwall_response(N_dec, low, high, gain)
    resp = window_filter(L_dec, M_dec, resp, beta)
    return resp.astype(np.complex64)
