"""Forward fill: "keep the last good sample" as a parallel select.

Port of ``ka9q_sdr_tpu.ops.ffill``.  The FM demodulator's threshold
extension (fm.c:128-144) replaces weak samples by the last strong sample's
value: out[n] = v[k] for the last k <= n with mask[k], else the row's init.

Two implementations of the same function:

- ``fill_plain``: plain PyTorch (cummax of the valid index, then a gather
  and a select).  It runs for CPU tensors, and it is what the tests and
  ``chip_smoke.py`` hold the kernel against.
- the Hopper kernel in ``csrc/ffill.cu`` (one warp per row, runs of 8
  positions per lane scanned in registers, joined by a ballot and a
  shuffle, a carry across chunks).  It replaces the TPU kernel
  ``_fill_pallas`` and runs for every CUDA tensor, at every size.

Both only select, so both are exact.  A complex value may be a conjugate
view (``torch.conj`` of a contiguous tensor): the kernel negates the
imaginary part as it reads, the plain version resolves the view, and both
give what ``torch.conj_physical`` would.  ``forward_fill_multi`` checks its
arguments the same way for both and raises on anything the kernel does not
take: a dtype other than float32/complex64, non-contiguous or negative-view
values, or shapes that differ from the mask.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["forward_fill", "forward_fill_multi", "last_true_index",
           "fill_plain"]

#: Kernel launches so far (one per ``forward_fill_multi`` call on CUDA
#: tensors); ``chip_smoke.py`` resets and reads it to show the main path
#: went through the kernel.
launches = 0

_MAX_VALUES = 4        # kMaxValues in csrc/ffill.cu
_WIDTH = {torch.float32: 1, torch.complex64: 2}


def last_true_index(mask: torch.Tensor) -> torch.Tensor:
    """For each position n (along the last axis), the largest k <= n with
    mask[k] true, or -1 if none (int64)."""
    n = mask.shape[-1]
    iota = torch.arange(n, dtype=torch.int64, device=mask.device)
    masked = torch.where(mask, iota, torch.full_like(iota, -1))
    return torch.cummax(masked, dim=-1).values


def fill_plain(values: tuple, mask: torch.Tensor, inits: tuple) -> tuple:
    """Plain PyTorch fill of several value tensors gated by one mask;
    `inits` have the mask's leading shape and each value's dtype."""
    idx = last_true_index(mask)
    src = idx.clamp(min=0)
    valid = idx >= 0
    return tuple(
        torch.where(valid, torch.gather(v.resolve_conj(), -1, src),
                    init[..., None])
        for v, init in zip(values, inits)
    )


def _fill_cuda(values: tuple, mask: torch.Tensor, inits: tuple) -> tuple:
    """Launch csrc/ffill.cu on (B, T)-flattened views of the arguments."""
    global launches
    from . import _kernels

    kl = _kernels.load("ffill")
    fn = kl.lib.ffill_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    T = mask.shape[-1]
    B = mask.numel() // T
    outs = tuple(torch.empty_like(v) for v in values)
    n = len(values)
    ptrs = ctypes.c_uint64 * n
    with torch.cuda.device(mask.device):
        err = fn(
            mask.data_ptr(), B, T, n,
            ptrs(*(v.data_ptr() for v in values)),
            ptrs(*(o.data_ptr() for o in outs)),
            ptrs(*(i.data_ptr() for i in inits)),
            (ctypes.c_int * n)(*(_WIDTH[v.dtype] for v in values)),
            (ctypes.c_int * n)(*(int(v.is_conj()) for v in values)),
            torch.cuda.current_stream(mask.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ffill kernel launch failed (error {err})")
    launches += 1
    return outs


def _checked_inits(values: tuple, mask: torch.Tensor, inits: tuple) -> tuple:
    """Validate the arguments for both implementations; return the inits
    as contiguous tensors of the mask's leading shape."""
    if mask.dtype != torch.bool or mask.ndim < 1 or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous bool tensor of rank >= 1")
    if not 1 <= len(values) <= _MAX_VALUES or len(inits) != len(values):
        raise ValueError(f"need 1..{_MAX_VALUES} values and one init each")
    lead = mask.shape[:-1]
    out = []
    for v, init in zip(values, inits):
        if v.dtype not in _WIDTH:
            raise TypeError(f"forward fill takes float32/complex64, not {v.dtype}")
        if v.shape != mask.shape:
            raise ValueError(f"value shape {tuple(v.shape)} != mask shape "
                             f"{tuple(mask.shape)}")
        if v.device != mask.device:
            raise ValueError("values and mask must share one device")
        if not v.is_contiguous() or v.is_neg():
            raise ValueError("values must be contiguous, with no neg view")
        if isinstance(init, torch.Tensor) and init.device != mask.device:
            raise ValueError("inits must lie on the mask's device")
        init = torch.as_tensor(init, dtype=v.dtype, device=mask.device)
        out.append(init.resolve_conj().expand(lead).contiguous())
    return tuple(out)


def forward_fill_multi(values: tuple, mask: torch.Tensor, inits: tuple) -> tuple:
    """Forward-fill SEVERAL value tensors gated by one shared mask:
    out_i[n] = values_i[k] for the last k <= n with mask[k], else inits_i.

    CUDA tensors go to the Hopper kernel, CPU tensors to ``fill_plain``."""
    values = tuple(values)
    inits = _checked_inits(values, mask, tuple(inits))
    if mask.device.type == "cuda":
        return _fill_cuda(values, mask, inits)
    if mask.device.type == "cpu":
        return fill_plain(values, mask, inits)
    raise ValueError(f"no forward fill for device {mask.device}")


def forward_fill(values: torch.Tensor, mask: torch.Tensor,
                 init) -> torch.Tensor:
    """out[n] = values[k] for the last k <= n with mask[k], else init.

    `values`/`mask` have shape (..., n); `init` broadcasts to (...,)."""
    return forward_fill_multi((values,), mask, (init,))[0]
