"""The forward-fill wrapper: its argument checks, which both
implementations share, and on a card the Hopper kernel against its plain
version (bit-exact: both only select).

This file imports no jax, so it also runs where jax is not installed, as on
the machine with the card (``tests/conftest.py`` configures jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu_torch.ops import ffill as TFF

torch.set_num_threads(1)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "conj",
                                 "mask_dtype", "too_many"])
def test_fill_rejects_what_the_kernel_does_not_take(bad):
    """Both implementations check their arguments alike, so a call that the
    kernel would refuse on the card fails on the CPU too."""
    v = torch.zeros((4, 16), dtype=torch.complex64)
    m = torch.ones((4, 16), dtype=torch.bool)
    values, inits = (v,), (0.0,)
    if bad == "dtype":
        values = (v.real.to(torch.float64).contiguous(),)
    elif bad == "shape":
        values = (v[:, :8].contiguous(),)
    elif bad == "strided":
        values = (torch.zeros((4, 32), dtype=torch.complex64)[:, ::2],)
    elif bad == "conj":
        values = (torch.conj(v),)
    elif bad == "mask_dtype":
        m = m.to(torch.uint8)
    elif bad == "too_many":
        values, inits = (v,) * 5, (0.0,) * 5
    with pytest.raises((TypeError, ValueError)):
        TFF.forward_fill_multi(values, m, inits)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 256), (7, 100), (130, 391), (4096, 960)])
def test_ffill_kernel_matches_plain_on_card(B, T):
    """One launch fills a float and a complex value sharing a mask, with
    every fifth row all weak (those take their init)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    v = rng.standard_normal((B, T)).astype(np.float32)
    c = (rng.standard_normal((B, T))
         + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    m = rng.random((B, T)) < 0.6
    m[::5] = False
    iv = rng.standard_normal(B).astype(np.float32)
    ic = (rng.standard_normal(B)
          + 1j * rng.standard_normal(B)).astype(np.complex64)
    v, c, m, iv, ic = (torch.as_tensor(a, device="cuda")
                       for a in (v, c, m, iv, ic))
    before = TFF.launches
    got = TFF.forward_fill_multi((v, c), m, (iv, ic))
    want = TFF.fill_plain((v, c), m, (iv, ic))
    torch.cuda.synchronize()
    assert TFF.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
