"""Parity of the PyTorch port's ops against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds and fed to both sides.
Tolerances, with their reasons:

- host-side filter design (numpy in both packages): bit-exact;
- integer and select-only math (NCO phase/frequency words, the phase ramp,
  the forward fill): bit-exact;
- FFT-based filtering: rtol/atol 1e-5 of the output scale — both sides
  compute in float32 with different FFT libraries (pocketfft in torch,
  ducc in XLA), which round differently at the ~1e-7 relative level;
- complex LO samples: atol 1e-6 — cos/sin of bit-identical phases, from
  two libm implementations (float32 ulp is 6e-8 near 1);
- the column Stockham FFT: relative error < 2e-6 of the spectrum's peak
  against np.fft and the JAX interpret-mode kernel (the JAX test's bound);
  the float64 recurrence within 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ka9q_sdr_tpu.ops import fftfilt as JF
from ka9q_sdr_tpu.ops import nco as JN
from ka9q_sdr_tpu.ops import window as JW
from ka9q_sdr_tpu.ops.ffill import (
    _fill_pallas,
    _fill_scan,
    last_true_index as j_last_true_index,
)
from ka9q_sdr_tpu_torch.ops import fftfilt as TF
from ka9q_sdr_tpu_torch.ops import ffill as TFF
from ka9q_sdr_tpu_torch.ops import nco as TN
from ka9q_sdr_tpu_torch.ops import pstock as TP
from ka9q_sdr_tpu_torch.ops import window as TW

torch.set_num_threads(1)


# ---------------------------------------------------------------- window

@pytest.mark.parametrize("M,beta", [(1, 3.0), (64, 3.0), (1089, 3.0), (33, 2.0)])
def test_kaiser_bit_exact(M, beta):
    np.testing.assert_array_equal(TW.make_kaiser(M, beta),
                                  JW.make_kaiser(M, beta))
    x = np.linspace(0, 20, 101)
    np.testing.assert_array_equal(TW.i0(x), JW.i0(x))


@pytest.mark.parametrize("L,M,dec,low,high", [
    (960, 1089, 1, -0.1, 0.2),
    (30720, 34817, 32, -8000 / 48000, 8000 / 48000),
])
def test_filter_design_bit_exact(L, M, dec, low, high):
    N = L + M - 1
    for real, cross in ((False, False), (True, False), (False, True)):
        np.testing.assert_array_equal(
            TW.design_bandpass(L, M, dec, low, high, real_output=real,
                               cross_conj=cross),
            JW.design_bandpass(L, M, dec, low, high, real_output=real,
                               cross_conj=cross))
    resp = JW.brickwall_response(N, low, high, 1.0 / N)
    np.testing.assert_array_equal(TW.brickwall_response(N, low, high, 1.0 / N),
                                  resp)
    np.testing.assert_array_equal(TW.window_filter(L, M, resp, 3.0),
                                  JW.window_filter(L, M, resp, 3.0))
    half = resp[: N // 2 + 1]
    np.testing.assert_array_equal(TW.window_rfilter(L, M, half, 2.0),
                                  JW.window_rfilter(L, M, half, 2.0))


# ---------------------------------------------------------------- fftfilt

_TYPES = {"COMPLEX": (JF.FilterType.COMPLEX, TF.FilterType.COMPLEX),
          "REAL": (JF.FilterType.REAL, TF.FilterType.REAL),
          "CROSS_CONJ": (JF.FilterType.CROSS_CONJ, TF.FilterType.CROSS_CONJ)}


@pytest.mark.parametrize("in_t,out_t", [
    ("COMPLEX", "COMPLEX"), ("COMPLEX", "REAL"), ("COMPLEX", "CROSS_CONJ"),
    ("REAL", "REAL"), ("REAL", "COMPLEX"), ("REAL", "CROSS_CONJ"),
])
def test_master_slave_execute(in_t, out_t):
    """Every in/out branch of slave_execute, streamed over 4 blocks."""
    L, M, dec = 384, 129, 4
    jm = JF.MasterSpec(L, M, _TYPES[in_t][0])
    tm = TF.MasterSpec(L, M, _TYPES[in_t][1])
    js = JF.SlaveSpec(jm, dec, _TYPES[out_t][0])
    ts = TF.SlaveSpec(tm, dec, _TYPES[out_t][1])
    resp = JF.set_filter_response(js, -0.3, 0.2, 3.0)
    np.testing.assert_array_equal(TF.set_filter_response(ts, -0.3, 0.2, 3.0),
                                  resp)
    assert TF.noise_gain(ts, resp) == JF.noise_gain(js, resp)
    rng = np.random.default_rng(7)
    jo = JF.master_init(jm)
    to = TF.master_init(tm, device="cpu")
    for _ in range(4):
        x = rng.standard_normal(L).astype(np.float32)
        if in_t != "REAL":
            x = (x + 1j * rng.standard_normal(L)).astype(np.complex64)
        jo, jfd = JF.master_execute(jm, jo, jnp.asarray(x))
        to, tfd = TF.master_execute(tm, to, torch.as_tensor(x))
        np.testing.assert_allclose(tfd.numpy(), np.asarray(jfd),
                                   rtol=1e-5, atol=1e-5 * np.abs(jfd).max())
        jy = np.asarray(JF.slave_execute(js, jfd, jnp.asarray(resp)))
        ty = TF.slave_execute(ts, tfd, torch.as_tensor(resp)).numpy()
        assert ty.dtype == jy.dtype and ty.shape == jy.shape
        np.testing.assert_allclose(ty, jy, rtol=1e-5,
                                   atol=1e-5 * np.abs(jy).max())
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_slave_bin_indices():
    jm = JF.MasterSpec(30720, 34817, JF.FilterType.COMPLEX)
    tm = TF.MasterSpec(30720, 34817, TF.FilterType.COMPLEX)
    np.testing.assert_array_equal(
        TF.slave_bin_indices(TF.SlaveSpec(tm, 32, TF.FilterType.COMPLEX)),
        JF.slave_bin_indices(JF.SlaveSpec(jm, 32, JF.FilterType.COMPLEX)))


# ---------------------------------------------------------------- nco

def _words(js, ts):
    return ((int(np.asarray(js.phase)), int(np.asarray(js.freq))),
            (int(ts.phase), int(ts.freq)))


@pytest.mark.parametrize("f,r", [(0.01234567, 3e-9), (-0.2718281828, -7e-8),
                                 (0.4999999999, 0.0)])
def test_nco_words_bit_exact(f, r):
    """Phase/frequency words, float residuals and the phase ramp agree
    exactly over 12 blocks of a swept oscillator."""
    js = JN.set_osc(JN.osc_init(), f, r)
    ts = TN.set_osc(TN.osc_init(device="cpu"), f, r)
    assert JN.split_double(f) == TN.split_double(f)
    for _ in range(12):
        np.testing.assert_array_equal(TN.phase_ramp(ts, 960).numpy(),
                                      np.asarray(JN.phase_ramp(js, 960)))
        js, jlo = JN.osc_block(js, 960)
        ts, tlo = TN.osc_block(ts, 960)
        jw, tw = _words(js, ts)
        assert jw == tw
        for a, b in ((js.freq_resid, ts.freq_resid),
                     (js.phase_resid, ts.phase_resid), (js.rate, ts.rate)):
            assert np.asarray(a) == b.numpy()
        np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), atol=1e-6)


def test_nco_batched_traced_and_mix():
    """Batched (B,) state, set_osc_traced's multi-cycle fold, nco_mix."""
    f = np.array([0.3, -2.7, 5.25, 1e-4], np.float32)
    js = JN.set_osc_traced(JN.OscState(*(jnp.zeros(4, d) for d in (
        jnp.uint32, jnp.uint32, jnp.float32, jnp.float32, jnp.float32))),
        jnp.asarray(f), 1e-7)
    ts = TN.set_osc_traced(TN.osc_init((4,), device="cpu"),
                           torch.as_tensor(f), 1e-7)
    rng = np.random.default_rng(2)
    for _ in range(10):
        x = (rng.standard_normal((4, 500))
             + 1j * rng.standard_normal((4, 500))).astype(np.complex64)
        js, jy = JN.nco_mix(js, jnp.asarray(x))
        ts, ty = TN.nco_mix(ts, torch.as_tensor(x))
        np.testing.assert_array_equal(ts.phase.numpy(), np.asarray(js.phase))
        np.testing.assert_array_equal(ts.freq.numpy(), np.asarray(js.freq))
        np.testing.assert_array_equal(ts.phase_resid.numpy(),
                                      np.asarray(js.phase_resid))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)


# ---------------------------------------------------------------- ffill

_FILL_SHAPES = [(64, 256), (7, 100), (130, 391)]


def _fill_case(B, T, seed=3):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, T)).astype(np.float32)
    c = (rng.standard_normal((B, T))
         + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    m = rng.random((B, T)) < 0.6
    m[::5] = False                                  # all-weak rows take init
    iv = rng.standard_normal(B).astype(np.float32)
    ic = (rng.standard_normal(B)
          + 1j * rng.standard_normal(B)).astype(np.complex64)
    return v, c, m, iv, ic


@pytest.mark.parametrize("B,T", _FILL_SHAPES)
def test_fill_plain_matches_scan(B, T):
    v, c, m, iv, ic = _fill_case(B, T)
    want = jax.jit(_fill_scan)((jnp.asarray(v), jnp.asarray(c)),
                               jnp.asarray(m),
                               (jnp.asarray(iv), jnp.asarray(ic)))
    got = TFF.forward_fill_multi(
        (torch.as_tensor(v), torch.as_tensor(c)), torch.as_tensor(m),
        (torch.as_tensor(iv), torch.as_tensor(ic)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        TFF.last_true_index(torch.as_tensor(m)).numpy(),
        np.asarray(j_last_true_index(jnp.asarray(m))))


@pytest.mark.parametrize("B,T", _FILL_SHAPES)
def test_fill_plain_matches_pallas_interpret(B, T):
    """The TPU kernel, run in interpret mode on f32 planes (a complex value
    is its real and imaginary planes), against the port on complex64."""
    v, c, m, iv, ic = _fill_case(B, T, seed=11)
    planes = tuple(jnp.asarray(p) for p in (v, c.real, c.imag))
    inits = tuple(jnp.asarray(p) for p in (iv, ic.real, ic.imag))
    fv, fre, fim = (np.asarray(o) for o in
                    _fill_pallas(planes, jnp.asarray(m), inits, interpret=True))
    tv, tc = TFF.forward_fill_multi(
        (torch.as_tensor(v), torch.as_tensor(c)), torch.as_tensor(m),
        (torch.as_tensor(iv), torch.as_tensor(ic)))
    np.testing.assert_array_equal(tv.numpy(), fv)
    np.testing.assert_array_equal(tc.numpy().real, fre)
    np.testing.assert_array_equal(tc.numpy().imag, fim)


def test_forward_fill_scalar_init_and_batch_dims():
    """forward_fill with (..., n) values and a broadcast init."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((2, 3, 50)).astype(np.float32)
    m = rng.random((2, 3, 50)) < 0.3
    from ka9q_sdr_tpu.ops.ffill import forward_fill as j_forward_fill

    want = np.asarray(jax.jit(j_forward_fill)(jnp.asarray(v), jnp.asarray(m),
                                              0.25))
    got = TFF.forward_fill(torch.as_tensor(v), torch.as_tensor(m), 0.25)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- pstock

@pytest.mark.parametrize("Q,W", [(1, 3), (16, 3), (1024, 3), (64, 5)])
def test_stockham_rows_matches_numpy(Q, W):
    from ka9q_sdr_tpu_torch.ops.pstock import stockham_rows_np

    rng = np.random.default_rng(Q)
    x = rng.standard_normal((Q, W)) + 1j * rng.standard_normal((Q, W))
    got = TP.stockham_rows(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, stockham_rows_np(x), rtol=0, atol=1e-12)
    want = np.fft.fft(x, axis=0)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("Q,P,CW", [(256, 512, 128), (64, 96, 32),
                                    (2, 8, 8)])
def test_fft_cols_plain_matches_numpy_and_interpret(Q, P, CW):
    from ka9q_sdr_tpu.ops.pstock import make_fft_cols as j_make_fft_cols

    rng = np.random.default_rng(P)
    x = (rng.standard_normal((Q, P))
         + 1j * rng.standard_normal((Q, P))).astype(np.complex64)
    xr, xi = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    yr, yi = TP.make_fft_cols(Q, P, CW)(torch.as_tensor(xr),
                                        torch.as_tensor(xi))
    got = yr.numpy() + 1j * yi.numpy()
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=0)) < 2e-6
    jr, ji = j_make_fft_cols(Q, P, CW, interpret=True)(jnp.asarray(xr),
                                                       jnp.asarray(xi))
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < 2e-6
    assert TP.launches == 0


@pytest.mark.parametrize("args", [(100, 8, 8), (64, 100, 32), (0, 8, 8),
                                  (32768, 8, 8)])
def test_make_fft_cols_rejects_bad_geometry(args):
    with pytest.raises(ValueError):
        TP.make_fft_cols(*args)


# ---------------------------------------------------------------- modes

def test_mode_table_matches_jax_package():
    import dataclasses

    from ka9q_sdr_tpu.utils import modes as JM
    from ka9q_sdr_tpu_torch.utils import modes as TM

    assert list(TM.DEFAULT_MODES) == list(JM.DEFAULT_MODES)
    for name, mode in JM.DEFAULT_MODES.items():
        assert dataclasses.astuple(TM.DEFAULT_MODES[name]) == \
            dataclasses.astuple(mode)
    text = "X  AM -1 +2 3 -4 5 0.5 mono square\nbad line\nY fm 9 1 0 0 0 0 flat"
    assert [dataclasses.astuple(m) for m in TM.parse_modes(text).values()] \
        == [dataclasses.astuple(m) for m in JM.parse_modes(text).values()]


def test_data_modes_txt_is_the_jax_packages():
    """data/modes.txt is a byte-equal copy of the JAX package's, and the
    port's parser reads it as the shipped table."""
    from pathlib import Path

    from ka9q_sdr_tpu_torch.utils import modes as TM

    root = Path(__file__).resolve().parent.parent
    port = (root / "ka9q_sdr_tpu_torch/data/modes.txt").read_bytes()
    assert port == (root / "ka9q_sdr_tpu/data/modes.txt").read_bytes()
    assert TM.parse_modes(port.decode()) == TM.DEFAULT_MODES
