"""Column FFT: autosorting Stockham FFT along axis 0.

Port of ``ka9q_sdr_tpu.ops.pstock``, a closed TPU experiment: no path of
either package calls it.  ``make_fft_cols(Q, P, CW)`` returns
``fft_cols(xr, xi) -> (yr, yi)``, the FFT along axis 0 of (Q, P) float32
re/im planes.  Two implementations of the same function:

- ``fft_cols_plain``: the TPU kernel's body (pstock.py:81-99, log2(Q)
  radix-2 stages) in plain PyTorch over all P columns at once (the columns
  are independent, so the slab width does not change the arithmetic).  It
  runs for CPU tensors, and it is what the tests and ``chip_smoke.py`` hold
  the kernel against.
- the Hopper kernel in ``csrc/pstock.cu``: mixed-radix passes (radix 16 in
  registers, the plan that ``radix_plan`` writes), split as Q = 16 (Q/16)
  over a cluster of thread blocks that exchange the first pass's outputs
  through distributed shared memory, twiddles from ``twiddle_table``.  The
  kernel is compiled once per Q and derives its plan and tile from Q;
  ``radix_plan`` is the same plan for the numpy model of its schedule
  (``tests/test_torch_kernels.py``).  It runs for every CUDA tensor.

The two round differently (the kernel's twiddles are float64 values
rounded to float32, the plain version's float32 cos/sin of a rounded
angle, and the butterflies differ), so they agree to float32 FFT accuracy,
not bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["stockham_rows", "stockham_rows_np", "make_fft_cols",
           "fft_cols_plain"]

#: Kernel launches so far (one per ``fft_cols`` call on CUDA tensors).
launches = 0

#: Largest Q the kernel takes (kMaxQ in csrc/pstock.cu).
MAX_Q = 16384

_twiddles: dict = {}     # (Q, device) -> complex64 table on that device


def radix_plan(Q: int) -> list[int]:
    """The kernel's radices (PlanOf in csrc/pstock.cu), first pass first:
    16 while it divides, then one pass of 2, 4 or 8; Q itself below 16 (a
    copy at Q = 1)."""
    q = Q.bit_length() - 1
    if Q < 1 or (1 << q) != Q:
        raise ValueError(f"Q={Q} not a power of two")
    if Q < 16:
        return [Q]
    return [16] * (q // 4) + ([1 << (q % 4)] if q % 4 else [])


def twiddle_table(Q: int) -> np.ndarray:
    """exp(-2 pi i t / Q) for t < Q: float64 cos/sin rounded to float32."""
    return np.exp(-2j * np.pi * np.arange(Q) / Q).astype(np.complex64)


def stockham_rows_np(x: np.ndarray) -> np.ndarray:
    """Reference recurrence (numpy): FFT over axis 0 of (Q, W), radix-2
    autosorting Stockham.  Exact vs np.fft.fft(axis=0)."""
    Q, W = x.shape
    y = x
    n, s = Q, 1
    while n > 1:
        m = n // 2
        v = y.reshape(n, s * W)
        a, b = v[:m], v[m:]
        w = np.exp(-2j * np.pi * np.arange(m) / n)[:, None]
        y = np.stack([a + b, (a - b) * w], axis=1).reshape(Q, W)
        n, s = m, s * 2
    return y


def stockham_rows(x: torch.Tensor) -> torch.Tensor:
    """Reference recurrence: FFT over axis 0 of a complex (Q, W) tensor,
    radix-2 autosorting Stockham (``stockham_rows_np`` on torch tensors;
    twiddles in float64, cast to x's dtype)."""
    Q, W = x.shape
    y = x
    n, s = Q, 1
    while n > 1:
        m = n // 2
        v = y.reshape(n, s * W)
        a, b = v[:m], v[m:]
        w = torch.as_tensor(np.exp(-2j * np.pi * np.arange(m) / n)[:, None],
                            dtype=x.dtype, device=x.device)
        y = torch.stack([a + b, (a - b) * w], dim=1).reshape(Q, W)
        n, s = m, s * 2
    return y


def fft_cols_plain(xr: torch.Tensor, xi: torch.Tensor):
    """The TPU kernel's stages in plain PyTorch: twiddles are float32
    cos/sin of float32(-2 pi / n) * p, as in pstock.py:91-93."""
    Q, P = xr.shape
    yr, yi = xr, xi
    n, s = Q, 1
    while n > 1:
        m = n // 2
        vr, vi = yr.reshape(n, s * P), yi.reshape(n, s * P)
        ar, br = vr[:m], vr[m:]
        ai, bi = vi[:m], vi[m:]
        p = torch.arange(m, dtype=torch.int32, device=xr.device)[:, None]
        ang = float(np.float32(-2.0 * np.pi / n)) * p.to(torch.float32)
        wr, wi = torch.cos(ang), torch.sin(ang)
        tr, ti = ar - br, ai - bi
        yr = torch.stack([ar + br, tr * wr - ti * wi], dim=1).reshape(Q, P)
        yi = torch.stack([ai + bi, tr * wi + ti * wr], dim=1).reshape(Q, P)
        n, s = m, s * 2
    return yr, yi


def _fft_cols_cuda(xr: torch.Tensor, xi: torch.Tensor):
    """Launch csrc/pstock.cu on (Q, P) planes."""
    global launches
    from . import _kernels

    fn = _kernels.load("pstock").lib.pstock_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    Q, P = xr.shape
    key = (Q, xr.device)
    if key not in _twiddles:
        _twiddles[key] = torch.as_tensor(twiddle_table(Q), device=xr.device)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    with torch.cuda.device(xr.device):
        err = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                 _twiddles[key].data_ptr(), Q, P,
                 torch.cuda.current_stream(xr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pstock kernel launch failed (error {err})")
    launches += 1
    return yr, yi


def make_fft_cols(Q: int, P: int, CW: int = 256):
    """Build ``fft_cols(xr, xi) -> (yr, yi)``: the FFT along axis 0 of
    (Q, P) float32 re/im planes.

    CW is the JAX kernel's column-slab width; it is kept for the same
    argument check (P % CW == 0).  The Hopper kernel chooses its own tile
    for each Q, and takes Q up to ``MAX_Q``."""
    q = Q.bit_length() - 1
    if Q < 1 or (1 << q) != Q:
        raise ValueError(f"Q={Q} not a power of two")
    if P % CW:
        raise ValueError(f"P={P} not a multiple of CW={CW}")
    if Q > MAX_Q:
        raise ValueError(f"Q={Q} does not fit one thread block's shared "
                         f"memory (at most {MAX_Q})")
    if Q * P >= 1 << 31:
        raise ValueError(f"Q*P={Q * P} overflows the kernel's 32-bit offsets")

    def fft_cols(xr: torch.Tensor, xi: torch.Tensor):
        for x in (xr, xi):
            if x.dtype != torch.float32 or tuple(x.shape) != (Q, P) \
                    or not x.is_contiguous():
                raise ValueError(f"fft_cols takes contiguous float32 ({Q}, "
                                 f"{P}) planes, not {x.dtype} "
                                 f"{tuple(x.shape)}")
        if xr.device != xi.device:
            raise ValueError("re and im planes must share one device")
        if xr.device.type == "cuda":
            return _fft_cols_cuda(xr, xi)
        if xr.device.type == "cpu":
            return fft_cols_plain(xr, xi)
        raise ValueError(f"no column FFT for device {xr.device}")

    return fft_cols
