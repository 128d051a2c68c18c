"""Overlap-save fast-convolution filter engine on torch tensors.

Port of ``ka9q_sdr_tpu.ops.fftfilt`` (the reference's master/slave filter,
filter.c:54-252).  One *master* holds the forward FFT of each input block;
any number of *slaves*, each with its own frequency response and decimation
ratio, share that FFT and do only a bin-wise multiply plus a short inverse
FFT.  State (the M-1 sample overlap) is explicit and carried by the caller.

Every FFT is ``torch.fft`` at every size: the JAX package's MXU matmul FFT
and four-step split are TPU shapes (PARITY.md #10) and have no counterpart
here.  Bin selection, conjugate folding, the CROSS_CONJ ISB trick and the
FFT scaling match filter.c exactly; see slave_execute for the mapping.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "FilterType",
    "MasterSpec",
    "SlaveSpec",
    "master_init",
    "master_execute",
    "slave_execute",
    "slave_bin_indices",
    "noise_gain",
    "set_filter_response",
]


class FilterType(enum.Enum):
    """Filter port types (filter.h:17-22)."""

    COMPLEX = "complex"
    REAL = "real"
    CROSS_CONJ = "cross_conj"  # complex with ISB cross-conjugation


class MasterSpec(NamedTuple):
    """Static description of a master (input) filter (struct filter_in,
    filter.h:54-66).  L = input block size, M = impulse length,
    N = L + M - 1 = FFT size."""

    L: int
    M: int
    in_type: FilterType

    @property
    def N(self) -> int:
        return self.L + self.M - 1

    @property
    def nbins(self) -> int:
        """Number of frequency bins the forward FFT produces."""
        return self.N // 2 + 1 if self.in_type is FilterType.REAL else self.N


class SlaveSpec(NamedTuple):
    """Static description of a slave (output) filter (struct filter_out,
    filter.h:67-80)."""

    master: MasterSpec
    decimate: int
    out_type: FilterType

    @property
    def N_dec(self) -> int:
        return self.master.N // self.decimate

    @property
    def olen(self) -> int:
        return self.master.L // self.decimate

    @property
    def nbins(self) -> int:
        """Length of the response array.  Only the real-in/real-out case
        stores half-spectrum responses; complex-in/real-out still needs the
        full response because the conjugate fold (filter.c:232-234) reads
        negative-frequency response bins."""
        if (
            self.master.in_type is FilterType.REAL
            and self.out_type is FilterType.REAL
        ):
            return self.N_dec // 2 + 1
        return self.N_dec


def master_init(spec: MasterSpec, batch_shape=(), *, device) -> torch.Tensor:
    """Zero overlap state: the trailing M-1 samples of the previous block
    (the memset of filter.c:76,85), float32 for a REAL master, else
    complex64."""
    dtype = torch.float32 if spec.in_type is FilterType.REAL else torch.complex64
    return torch.zeros(tuple(batch_shape) + (spec.M - 1,), dtype=dtype,
                       device=device)


def master_execute(
    spec: MasterSpec, overlap: torch.Tensor, block: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One overlap-save step (execute_filter_input, filter.c:146-172).

    Concatenates the carried M-1 overlap with the new L-sample block,
    forward-FFTs the N samples, and returns (new_overlap, fdomain).  The FFT
    is unnormalised-forward, matching FFTW_FORWARD."""
    if block.shape[-1] != spec.L:
        raise ValueError(f"block length {block.shape[-1]} != L = {spec.L}")
    buf = torch.cat([overlap, block], dim=-1)
    if spec.in_type is FilterType.REAL:
        fdomain = torch.fft.rfft(buf, dim=-1)
    else:
        fdomain = torch.fft.fft(buf, dim=-1)
    return buf[..., spec.L:], fdomain


def slave_bin_indices(spec: SlaveSpec) -> np.ndarray:
    """Master-spectrum bin index for each slave bin, as gathered by
    execute_filter_output (filter.c:206,225-227).

    For complex-in/complex-out: slave bin p in 0..N_dec/2 reads master bin
    p; slave bin dn in N_dec/2+1..N_dec-1 reads master bin N - N_dec + dn
    (the top of the master spectrum, i.e. the negative frequencies).  The
    channel bank reuses this pattern shifted by an integer bin rotation per
    channel."""
    N, N_dec = spec.master.N, spec.N_dec
    h = N_dec // 2
    if spec.master.in_type is not FilterType.REAL and spec.out_type in (
        FilterType.COMPLEX,
        FilterType.CROSS_CONJ,
    ):
        return np.concatenate([np.arange(h + 1), np.arange(N - h + 1, N)])
    raise ValueError("bin indices only defined for complex in / complex out")


def _cross_conj(f_fd: torch.Tensor, N_dec: int) -> torch.Tensor:
    """ISB cross-conjugate trick (filter.c:239-249): for p in 1..N_dec/2-1
    paired with dn = N_dec - p, replace (pos, neg) with
    (pos + conj(neg), neg - conj(pos)).  Forces the lower sideband onto I
    and the upper onto Q."""
    h = N_dec // 2
    pos = f_fd[..., 1:h]                              # p = 1 .. h-1
    neg = f_fd[..., h + 1:].flip(-1)                  # dn = N_dec-1 .. h+1
    new_pos = pos + torch.conj(neg)
    new_neg = neg - torch.conj(pos)
    return torch.cat(
        [f_fd[..., :1], new_pos, f_fd[..., h:h + 1], new_neg.flip(-1)],
        dim=-1,
    )


def slave_execute(
    spec: SlaveSpec, fdomain: torch.Tensor, response: torch.Tensor
) -> torch.Tensor:
    """One slave step (execute_filter_output, filter.c:175-252).

    Multiplies the shared master spectrum by this slave's frequency response
    with the reference's exact bin mapping and conjugate folding,
    inverse-FFTs at the decimated size, and returns the last `olen` (valid)
    output samples.  The IFFT is unnormalised (FFTW_BACKWARD), i.e.
    N_dec * ifft()."""
    N, N_dec = spec.master.N, spec.N_dec
    h = N_dec // 2
    in_real = spec.master.in_type is FilterType.REAL
    out = spec.out_type

    if response.shape[-1] != spec.nbins:
        raise ValueError(f"response length {response.shape[-1]} != {spec.nbins}")

    if not in_real and out in (FilterType.COMPLEX, FilterType.CROSS_CONJ):
        # complex in, complex out (filter.c:206-207, 225-227)
        pos = response[..., : h + 1] * fdomain[..., : h + 1]
        neg = response[..., h + 1:] * fdomain[..., N - h + 1:]
        f_fd = torch.cat([pos, neg], dim=-1)
        if out is FilterType.CROSS_CONJ:
            f_fd = _cross_conj(f_fd, N_dec)
        y = torch.fft.ifft(f_fd, dim=-1) * N_dec
        return y[..., N_dec - spec.olen:]

    if not in_real and out is FilterType.REAL:
        # complex in, real out: fold conjugates of negative frequencies into
        # the positive bins (filter.c:228-235): p in 1..h-1 takes
        # dn = N_dec-p from master bin n = N-p.
        pos = response[..., : h + 1] * fdomain[..., : h + 1]
        fold = torch.conj(
            response[..., h + 1:].flip(-1)
            * fdomain[..., N - h + 1:].flip(-1)
        )
        pos = torch.cat(
            [pos[..., :1], pos[..., 1:h] + fold, pos[..., h:]], dim=-1
        )
        y = torch.fft.irfft(pos, N_dec, dim=-1) * N_dec
        return y[..., N_dec - spec.olen:]

    if in_real and out is FilterType.REAL:
        # real in, real out (filter.c:206-207 only): first N_dec/2+1 bins.
        f_fd = response[..., : h + 1] * fdomain[..., : h + 1]
        y = torch.fft.irfft(f_fd, N_dec, dim=-1) * N_dec
        return y[..., N_dec - spec.olen:]

    if in_real and out in (FilterType.COMPLEX, FilterType.CROSS_CONJ):
        # real in, complex out: F[-f] = conj(F[+f]) (filter.c:209-216),
        # dn = N_dec-1..h+1 reads p = 1..h-1.
        pos = response[..., : h + 1] * fdomain[..., : h + 1]
        neg = response[..., h + 1:] * torch.conj(fdomain[..., 1:h].flip(-1))
        f_fd = torch.cat([pos, neg], dim=-1)
        if out is FilterType.CROSS_CONJ:
            f_fd = _cross_conj(f_fd, N_dec)
        y = torch.fft.ifft(f_fd, dim=-1) * N_dec
        return y[..., N_dec - spec.olen:]

    raise ValueError(f"unsupported type combination {spec.master.in_type}/{out}")


def noise_gain(spec: SlaveSpec, response: np.ndarray) -> float:
    """Filter gain on uniform gaussian noise (filter.c:472-497).

    Sum of |response|^2 over the slave's bins, times N (undoing the 1/N
    amplitude pre-scale), times 2 for REAL / CROSS_CONJ outputs (undoing
    their sqrt(1/2) amplitude factor)."""
    N = spec.master.N
    if spec.master.in_type is FilterType.REAL and spec.out_type is FilterType.REAL:
        s = float(np.sum(np.abs(response[: spec.N_dec // 2 + 1]) ** 2))
    else:
        s = float(np.sum(np.abs(response[: spec.N_dec]) ** 2))
    if spec.out_type in (FilterType.REAL, FilterType.CROSS_CONJ):
        return 2.0 * N * s
    return float(N * s)


def set_filter_response(
    spec: SlaveSpec, low: float, high: float, beta: float
) -> np.ndarray:
    """Design a slave's response à la set_filter (filter.c:500-546).

    low/high are in cycles/sample of the *decimated* output rate.  Returns
    the complex64 response as a host array."""
    from .window import brickwall_response, design_bandpass, window_rfilter

    if (
        spec.master.in_type is FilterType.REAL
        and spec.out_type is FilterType.REAL
    ):
        # Half-spectrum design via window_rfilter, as the reference's
        # real/real users do directly (fm.c:56-65, packet.c).
        L_dec = spec.master.L // spec.decimate
        M_dec = (spec.master.M - 1) // spec.decimate + 1
        gain = np.sqrt(0.5) / spec.master.N
        full = brickwall_response(spec.N_dec, low, high, gain)
        resp = window_rfilter(L_dec, M_dec, full[: spec.N_dec // 2 + 1], beta)
        return resp.astype(np.complex64)

    return design_bandpass(
        spec.master.L,
        spec.master.M,
        spec.decimate,
        low,
        high,
        beta,
        real_output=spec.out_type is FilterType.REAL,
        cross_conj=spec.out_type is FilterType.CROSS_CONJ,
    )
