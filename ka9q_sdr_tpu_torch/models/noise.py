"""Noise spectral density estimation from the master filter spectrum.

Port of ``ka9q_sdr_tpu.models.noise`` (compute_n0, radio.c:383-425): average
the power of all master FFT bins outside the demodulator's passband, then
re-average excluding bins more than 3 dB above the first average (to reject
signals).  Two masked reductions over the N-bin spectrum, plain torch: the
JAX package computes them outside any Pallas kernel.

``compute_n0`` broadcasts over leading batch axes; the JAX function runs
only unbatched (or under ``jax.vmap``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["passband_mask", "compute_n0"]


def passband_mask(N: int, samprate: float, low: float, high: float) -> np.ndarray:
    """Boolean mask of master FFT bins inside [low, high] Hz
    (radio.c:404-412).  Bin n maps to f = n*fs/N for n <= N/2 and
    (n-N)*fs/N above.  Host-side numpy, a copy of the JAX package's (whose
    module imports jax)."""
    n = np.arange(N)
    f = np.where(n <= N // 2, n, n - N) * (samprate / N)
    return (f >= low) & (f <= high)


def compute_n0(fdomain: torch.Tensor, in_passband: torch.Tensor,
               samprate: float) -> torch.Tensor:
    """Noise power per Hz normalised to 0 dBFS (radio.c:383-425).

    `fdomain` is the master filter's (..., N) spectrum; `in_passband` the
    (N,) mask from passband_mask, on fdomain's device.  Two fixed
    iterations: the first averages all out-of-passband bins (avg = inf
    admits everything), the second drops bins > 3 dB (2x power) above the
    first average."""
    ps = fdomain.real ** 2 + fdomain.imag ** 2
    N = ps.shape[-1]
    keep_base = ~in_passband
    avg = torch.full(ps.shape[:-1], float("inf"), dtype=torch.float32,
                     device=ps.device)
    for _ in range(2):
        keep = keep_base & (ps < (avg * 2.0)[..., None])
        cnt = torch.clamp_min(torch.sum(keep, dim=-1), 1)
        avg = torch.sum(torch.where(keep, ps, 0.0), dim=-1) / cnt
    # a tensor divisor: on CUDA torch computes `tensor / number` as a
    # multiply by the reciprocal, not the correctly rounded quotient (made
    # by a fill on the device: an upload would wait for the stream)
    den = torch.full((), float(np.float32(2.0 * N * samprate)),
                     dtype=torch.float32, device=ps.device)
    return avg / den
