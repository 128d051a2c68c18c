"""Distributed wideband FFT over a channel mesh (the JAX package's
``parallel/dfft.py``, same math).

With N = P*Q over the P devices of a mesh and the block *time-sharded*
(device p holds x[p*Q:(p+1)*Q]):

1. small cross-device DFT: y_j[q] = sum_p x_p[q] * W_P^(j*p).  Device p
   forms its P partial products W_P[:, p] x_p, and a reduce-scatter delivers
   y_j = sum_p to device j: the only communication, N complex values.
2. twiddle and local FFT: X[j + P*m] = FFT_q(W_N^(j*q) * y_j[q])[m], with
   ``fft_fourstep`` for local slices of 2^25 points or more.

Device j ends up owning the comb {j, j+P, j+2P, ...}.  The port drives the
mesh from one process: the reduce-scatter is P sums of tensors copied to
their destination device (peer copies between cards, no copy at all where
the mesh repeats one card).  ``comb_gather`` gathers a channel bank's bins
straight from the comb slices where they live; ``undo_comb`` reassembles a
natural-order spectrum on the host, for checks only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fftfilt import FOURSTEP_MIN, fft_fourstep

__all__ = ["dfft", "undo_comb", "make_dfft", "make_dfft_sm", "comb_index",
           "comb_gather"]


def make_dfft_sm(mesh, N: int):
    """The per-device form of the distributed FFT over `mesh` for length-N
    blocks, the part the sharded channel bank runs (the role of the JAX
    package's shard_map'd ``make_dfft_sm``).

    Returns fn(parts) -> combs: parts[p] is device p's (Q,) complex64 time
    slice, combs[j] device j's (Q,) comb slice, combs[j][m] = X[j + P*m]."""
    P = mesh.size
    if N % P:
        raise ValueError(f"N={N} not divisible by {P} devices")
    Q = N // P
    # cross-device DFT matrix W_P^(j*p), tiny (P x P)
    j = np.arange(P)
    WP = np.exp(-2j * np.pi * np.outer(j, j) / P).astype(np.complex64)
    cols = [torch.as_tensor(WP[:, p], device=dev)
            for p, dev in enumerate(mesh.devices)]
    # the JAX package's twiddle expression: float32 j*q, complex64 exp
    q = torch.arange(Q, dtype=torch.float32)
    tws = [torch.exp((-2j * np.pi / N) * (float(jj) * q)).to(dev)
           for jj, dev in enumerate(mesh.devices)]
    local_fft = fft_fourstep if Q >= FOURSTEP_MIN else (
        lambda y: torch.fft.fft(y, dim=-1))

    def fn(parts):
        if len(parts) != P or any(x.shape != (Q,) for x in parts):
            raise ValueError(f"need {P} time slices of {Q} samples")
        # partial products for every destination j: (P, Q) on device p
        z = [col[:, None] * x[None, :] for col, x in zip(cols, parts)]
        combs = []
        for jj, dev in enumerate(mesh.devices):
            y = z[0][jj].to(dev)
            for zp in z[1:]:
                y = y + zp[jj].to(dev)
            combs.append(local_fft(y * tws[jj]))
        return combs

    return fn


def make_dfft(mesh, N: int):
    """Standalone form of ``make_dfft_sm``: fn(x) takes an (N,) complex64
    block, splits it over the mesh and returns the comb-major (N,) spectrum,
    out[j*Q + m] = X[j + P*m], on the mesh's first device."""
    sm = make_dfft_sm(mesh, N)
    Q = N // mesh.size

    def fn(x):
        x = torch.as_tensor(x, dtype=torch.complex64)
        parts = [x[p * Q:(p + 1) * Q].to(dev)
                 for p, dev in enumerate(mesh.devices)]
        first = mesh.devices[0]
        return torch.cat([c.to(first) for c in sm(parts)])

    return fn


def comb_index(N: int, n_devices: int) -> np.ndarray:
    """perm such that X_true[k] = out[perm[k]] for make_dfft's output."""
    Q = N // n_devices
    k = np.arange(N)
    return (k % n_devices) * Q + k // n_devices


def undo_comb(out, n_devices: int) -> np.ndarray:
    """Reassemble the natural-order spectrum from the comb layout."""
    out = np.asarray(out)
    return out[comb_index(len(out), n_devices)]


def dfft(mesh, x) -> np.ndarray:
    """One-shot helper: the distributed FFT of x, returned in natural order
    on the host (for checks; the bank addresses the comb directly)."""
    out = make_dfft(mesh, len(x))(x)
    return undo_comb(out.cpu().numpy(), mesh.size)


def comb_gather(combs, idx: torch.Tensor) -> torch.Tensor:
    """spectrum[idx] for (B, N_dec) true-bin indices, where the spectrum is
    the P comb slices of ``make_dfft_sm`` (bin b lives on device b % P at
    position b // P), onto idx's device.

    Each row of idx is a channel's window of consecutive bins in slave
    order, whose column i holds a bin of residue (idx[:, 0] + i) mod P (the
    caller checks this of its gather pattern).  So the columns that device j
    serves are every P-th one from r = (j - idx[:, 0]) mod P: device j
    gathers exactly those B*N_dec/P bins, and no spectrum is reassembled."""
    P = len(combs)
    B, n_dec = idx.shape
    dev = idx.device
    idx3 = idx.reshape(B, n_dec // P, P)
    out = torch.empty((B, n_dec // P, P), dtype=torch.complex64, device=dev)
    for j, comb in enumerate(combs):
        r = ((j - idx[:, 0]) % P)[:, None, None].expand(B, n_dec // P, 1)
        pos = torch.gather(idx3, 2, r) // P
        out.scatter_(2, r, comb[pos.to(comb.device)].to(dev))
    return out.reshape(B, n_dec)
