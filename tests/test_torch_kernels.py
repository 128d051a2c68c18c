"""The kernel wrappers (forward fill, hang AGC, column FFT): their argument
checks, which both implementations share, and on a card each Hopper kernel
against its plain version: the fill and the AGC bit-exact (selects, and
IEEE float32 steps with no a*b+c), the column FFT within 2e-6 of the
spectrum's peak (twiddles rounded differently).

This file imports no jax, so it also runs where jax is not installed, as on
the machine with the card (``tests/conftest.py`` configures jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu_torch.ops import agc as TA
from ka9q_sdr_tpu_torch.ops import ffill as TFF
from ka9q_sdr_tpu_torch.ops import pstock as TP

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


@pytest.mark.parametrize("bad", ["dtype", "gain_shape", "hang_dtype",
                                 "empty"])
def test_agc_rejects_what_the_kernel_does_not_take(bad):
    params = TA.AGCParams.from_mode(-15.0, 6.0, 1.1, 1.0 / 48000)
    lev = torch.ones((4, 16))
    st = TA.agc_init(100.0, (4,), device="cpu")
    if bad == "dtype":
        lev = lev.to(torch.float64)
    elif bad == "gain_shape":
        st = st._replace(gain=torch.ones(5))
    elif bad == "hang_dtype":
        st = st._replace(hangcount=torch.zeros(4, dtype=torch.int64))
    elif bad == "empty":
        lev = torch.ones((4, 0))
    with pytest.raises((TypeError, ValueError)):
        TA.agc_block(st, lev, params)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "devices"])
def test_fft_cols_rejects_what_the_kernel_does_not_take(bad):
    f = TP.make_fft_cols(16, 8, 8)
    xr, xi = torch.zeros((16, 8)), torch.zeros((16, 8))
    if bad == "dtype":
        xr = xr.to(torch.float64)
    elif bad == "shape":
        xr = torch.zeros((8, 16))
    elif bad == "strided":
        xr = torch.zeros((16, 16))[:, ::2]
    elif bad == "devices":
        xr = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError):
        f(xr, xi)


def _agc_case(B, T, seed):
    """Levels over 60 dB with zero runs; a NaN gain on a zero level (the
    gain goes inf), hang counts above zero at entry."""
    rng = np.random.default_rng(seed)
    lev = (10.0 ** rng.uniform(-4, -1, (B, T))).astype(np.float32)
    lev[:, T // 3: T // 3 + 5] = 0.0
    gain = (10.0 ** rng.uniform(0, 5, B)).astype(np.float32)
    gain[::7] = np.nan
    lev[::7, :3] = 0.0
    hang = rng.integers(0, 40, B).astype(np.int32)
    return lev, gain, hang


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 256), (7, 100), (130, 391),
                                 (4096, 960)])
def test_agc_kernel_matches_plain_on_card(B, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lev, gain, hang = (torch.as_tensor(a, device="cuda")
                       for a in _agc_case(B, T, seed=T))
    for params in (TA.AGCParams.from_mode(-15.0, 50.0, 0.0, 1 / 48000),
                   TA.AGCParams.from_mode(-15.0, 6.0, 1.1, 1 / 48000)):
        before = TA.launches
        st, got = TA.agc_block(TA.AGCState(gain, hang), lev, params)
        want, g, h = TA.agc_plain(gain, hang, lev, params)
        torch.cuda.synchronize()
        assert TA.launches == before + 1
        assert torch.equal(got, want)
        assert torch.equal(st.gain, g) and torch.equal(st.hangcount, h)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,P,CW", [(256, 512, 128), (4096, 256, 256),
                                    (1024, 96, 32), (16384, 8, 8)])
def test_fft_cols_kernel_matches_plain_on_card(Q, P, CW):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(Q + P)
    x = (rng.standard_normal((Q, P))
         + 1j * rng.standard_normal((Q, P))).astype(np.complex64)
    xr = torch.as_tensor(np.ascontiguousarray(x.real), device="cuda")
    xi = torch.as_tensor(np.ascontiguousarray(x.imag), device="cuda")
    before = TP.launches
    yr, yi = TP.make_fft_cols(Q, P, CW)(xr, xi)
    pr, pi = TP.fft_cols_plain(xr, xi)
    torch.cuda.synchronize()
    assert TP.launches == before + 1
    got = yr.cpu().numpy() + 1j * yi.cpu().numpy()
    want = np.fft.fft(x.astype(np.complex128), axis=0)
    plain = pr.cpu().numpy() + 1j * pi.cpu().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
    assert np.abs(got - plain).max() / np.abs(plain).max() < 2e-6
