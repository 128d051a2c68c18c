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
the mesh repeats one card).  Each step has two halves, one a device
(``DistributedFFT.partials`` and ``.combine``), which a card runs as a
chain of captured graphs.  ``comb_gather`` gathers a channel bank's bins
straight from the comb slices where they live; ``undo_comb`` reassembles a
natural-order spectrum on the host, for checks only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fftfilt import FOURSTEP_MIN, fft_fourstep
from ..utils.graphs import MeshGraphs, fetch

__all__ = ["dfft", "undo_comb", "make_dfft", "make_dfft_sm", "comb_index",
           "comb_gather", "comb_positions", "comb_assemble",
           "DistributedFFT"]


class DistributedFFT:
    """``make_dfft_sm``'s result: the distributed FFT of length-N blocks
    over a mesh, as its two halves, each on one device, and their
    composition.

    - ``partials(p, x_p)``: device p's partial products W_P[:, p] x_p,
      (P, Q), row j for device j;
    - ``combine(j, slices)``: device j's sum of the P slices z_p[j], in
      the order p = 0, 1, ..., P-1, then the twiddle and the local FFT:
      comb slice j, combs[j][m] = X[j + P*m];
    - called on the P time slices: every comb slice, each on its device
      (the halves joined by copies to the destination device)."""

    def __init__(self, mesh, N: int):
        P = mesh.size
        if N % P:
            raise ValueError(f"N={N} not divisible by {P} devices")
        self.devices, self.P, self.Q = mesh.devices, P, N // P
        # cross-device DFT matrix W_P^(j*p), tiny (P x P)
        j = np.arange(P)
        WP = np.exp(-2j * np.pi * np.outer(j, j) / P).astype(np.complex64)
        self.cols = [torch.as_tensor(WP[:, p], device=dev)
                     for p, dev in enumerate(mesh.devices)]
        # the JAX package's twiddle expression: float32 j*q, complex64 exp
        q = torch.arange(self.Q, dtype=torch.float32)
        self.tws = [torch.exp((-2j * np.pi / N) * (float(jj) * q)).to(dev)
                    for jj, dev in enumerate(mesh.devices)]
        self.local_fft = fft_fourstep if self.Q >= FOURSTEP_MIN else (
            lambda y: torch.fft.fft(y, dim=-1))

    def partials(self, p: int, x: torch.Tensor) -> torch.Tensor:
        return self.cols[p][:, None] * x[None, :]

    def combine(self, j: int, slices) -> torch.Tensor:
        y = slices[0]
        for z in slices[1:]:
            y = y + z
        return self.local_fft(y * self.tws[j])

    def __call__(self, parts):
        if len(parts) != self.P or any(x.shape != (self.Q,) for x in parts):
            raise ValueError(f"need {self.P} time slices of {self.Q} "
                             f"samples")
        z = [self.partials(p, x) for p, x in enumerate(parts)]
        return [self.combine(j, [zp[j].to(dev) for zp in z])
                for j, dev in enumerate(self.devices)]


def make_dfft_sm(mesh, N: int) -> DistributedFFT:
    """The per-device form of the distributed FFT over `mesh` for length-N
    blocks, the part the sharded channel bank runs (the role of the JAX
    package's shard_map'd ``make_dfft_sm``).

    Returns fn(parts) -> combs: parts[p] is device p's (Q,) complex64 time
    slice, combs[j] device j's (Q,) comb slice, combs[j][m] = X[j + P*m];
    fn.partials and fn.combine are its halves (``DistributedFFT``)."""
    return DistributedFFT(mesh, N)


def make_dfft(mesh, N: int, capture: bool = True):
    """Standalone form of ``make_dfft_sm`` (the JAX package's jitted
    ``make_dfft``): fn(x) takes an (N,) complex64 block, splits it over the
    mesh and returns the comb-major (N,) spectrum, out[j*Q + m] = X[j +
    P*m], on the mesh's first device.  On cards the halves run as a chain
    of captured graphs, one a device for each (``utils.graphs.MeshGraphs``,
    ``fn.graphs``); `capture=False` runs them eagerly."""
    sm = make_dfft_sm(mesh, N)
    Q, devs = sm.Q, mesh.devices
    graphs = MeshGraphs(devs, capture)
    links = (lambda p: lambda s, x: (s, sm.partials(p, x)),
             lambda j: lambda s, z: (s, sm.combine(
                 j, [fetch(zp[j], devs[j]) for zp in z])))

    def fn(x):
        x = torch.as_tensor(x, dtype=torch.complex64)
        parts = [x[p * Q:(p + 1) * Q].to(dev) for p, dev in enumerate(devs)]
        combs = graphs.chain("dfft", links, [()] * mesh.size, parts)
        return torch.cat([c.to(devs[0]) for c in combs])

    fn.graphs = graphs
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


def _residue(idx: torch.Tensor, j: int, P: int) -> torch.Tensor:
    """(B, N_dec/P, 1): the column, within each group of P columns of a
    channel's window, whose bin lives on device j."""
    B, n_dec = idx.shape
    return ((j - idx[:, 0]) % P)[:, None, None].expand(B, n_dec // P, 1)


def comb_positions(idx: torch.Tensor, P: int) -> torch.Tensor:
    """(P, B, N_dec/P, 1): row j holds where device j's comb slice keeps
    the bins of (B, N_dec) true-bin indices that live there (the
    gather's first half, on idx's device)."""
    B, n_dec = idx.shape
    idx3 = idx.reshape(B, n_dec // P, P)
    return torch.stack([torch.gather(idx3, 2, _residue(idx, j, P)) // P
                        for j in range(P)])


def comb_assemble(parts, idx: torch.Tensor) -> torch.Tensor:
    """The (B, N_dec) gathered bins from parts[j] = comb_j[positions[j]]
    (each (B, N_dec/P, 1), on idx's device): the gather's second half."""
    P = len(parts)
    B, n_dec = idx.shape
    out = torch.empty((B, n_dec // P, P), dtype=torch.complex64,
                      device=idx.device)
    for j, part in enumerate(parts):
        out.scatter_(2, _residue(idx, j, P), part)
    return out.reshape(B, n_dec)


def comb_gather(combs, idx: torch.Tensor) -> torch.Tensor:
    """spectrum[idx] for (B, N_dec) true-bin indices, where the spectrum is
    the P comb slices of ``make_dfft_sm`` (bin b lives on device b % P at
    position b // P), onto idx's device.

    Each row of idx is a channel's window of consecutive bins in slave
    order, whose column i holds a bin of residue (idx[:, 0] + i) mod P (the
    caller checks this of its gather pattern).  So the columns that device j
    serves are every P-th one from r = (j - idx[:, 0]) mod P: device j
    gathers exactly those B*N_dec/P bins (``comb_positions``), the
    destination places them (``comb_assemble``), and no spectrum is
    reassembled."""
    pos = comb_positions(idx, len(combs))
    return comb_assemble([comb[p.to(comb.device)].to(idx.device)
                          for comb, p in zip(combs, pos)], idx)
