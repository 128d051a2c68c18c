"""Parity of the port's hang AGC, one-pole scan and half-band cascade
against the JAX package on the CPU.

Tolerances, with their reasons:

- ``agc_block`` and ``agc_block_coarse``: bit-exact.  The step is IEEE
  float32 division, multiplication and selects with no a*b+c, so both sides
  round alike; the cases include a NaN gain (the ``bad`` branch), zero
  levels (headroom/0 = inf), a hang count above zero at entry and hangmax
  above zero.
- ``one_pole_lowpass``: within 1e-6 of the output's scale.  The port's
  Hillis-Steele scan combines in another tree than JAX's associative_scan.
- ``hb_cascade``: within 1e-6 of scale over several blocks of carried state
  (the same strided-slice sums in the same order; XLA may fuse them into
  fused multiply-adds).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ka9q_sdr_tpu.ops import agc as JA
from ka9q_sdr_tpu.ops import decimate as JD
from ka9q_sdr_tpu.ops import iir as JI
from ka9q_sdr_tpu_torch.ops import agc as TA
from ka9q_sdr_tpu_torch.ops import decimate as TD
from ka9q_sdr_tpu_torch.ops import iir as TI

torch.set_num_threads(1)


def _agc_case(B, T, seed):
    """Levels spanning 60 dB with zero runs, a NaN gain, hang > 0."""
    rng = np.random.default_rng(seed)
    lev = (10.0 ** rng.uniform(-4, -1, (B, T))).astype(np.float32)
    lev[:, T // 3: T // 3 + 5] = 0.0                 # headroom/0 = inf
    lev[1, :] = 0.0                                  # a silent channel
    gain = (10.0 ** rng.uniform(0, 5, B)).astype(np.float32)
    gain[0] = np.nan                                 # the `bad` branch
    lev[0, :3] = 0.0                 # ... at a zero level: the gain goes inf
    hang = rng.integers(0, 40, B).astype(np.int32)   # hang > 0 at entry
    return lev, gain, hang


# (headroom dB, recovery dB/s, hang s): AM (no hang), linear, CW
_PARAMS = [(-15.0, 50.0, 0.0), (-15.0, 6.0, 1.1), (-10.0, 20.0, 0.002)]


@pytest.mark.parametrize("hr,rec,hangt", _PARAMS)
@pytest.mark.parametrize("B,T", [(8, 960), (7, 100), (3, 391)])
def test_agc_block_bit_exact(B, T, hr, rec, hangt):
    params = JA.AGCParams.from_mode(hr, rec, hangt, 1.0 / 48000)
    assert TA.AGCParams.from_mode(hr, rec, hangt, 1.0 / 48000) == params
    lev, gain, hang = _agc_case(B, T, seed=B * T)
    js = JA.AGCState(jnp.asarray(gain), jnp.asarray(hang))
    ts = TA.AGCState(torch.as_tensor(gain), torch.as_tensor(hang))
    step = jax.jit(lambda s, x: JA.agc_block(s, x, params))
    infs = 0
    for blk in range(3):            # carried state across blocks
        x = lev if blk == 0 else np.roll(lev, blk * 17, axis=1)
        js, jg = step(js, jnp.asarray(x))
        ts, tg = TA.agc_block(ts, torch.as_tensor(x), params)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(ts.gain.numpy(), np.asarray(js.gain))
        np.testing.assert_array_equal(ts.hangcount.numpy(),
                                      np.asarray(js.hangcount))
        infs += int(np.isinf(tg.numpy()).sum())
    assert infs > 0


def test_agc_block_batch_dims_and_init():
    params = TA.AGCParams.from_mode(-15.0, 6.0, 1.1, 1.0 / 48000)
    js = JA.agc_init(100.0, (2, 3))
    ts = TA.agc_init(100.0, (2, 3), device="cpu")
    np.testing.assert_array_equal(ts.gain.numpy(), np.asarray(js.gain))
    lev = np.random.default_rng(1).random((2, 3, 50)).astype(np.float32)
    js, jg = JA.agc_block(js, jnp.asarray(lev), params)
    ts, tg = TA.agc_block(ts, torch.as_tensor(lev), params)
    assert tg.shape == (2, 3, 50) and ts.gain.shape == (2, 3)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("hr,rec,hangt", _PARAMS)
def test_agc_block_coarse_bit_exact(hr, rec, hangt):
    params = JA.AGCParams.from_mode(hr, rec, hangt, 1.0 / 48000)
    lev, gain, hang = _agc_case(8, 960, seed=4)
    js = JA.AGCState(jnp.asarray(gain), jnp.asarray(hang))
    ts = TA.AGCState(torch.as_tensor(gain), torch.as_tensor(hang))
    for _ in range(3):
        js, jg = JA.agc_block_coarse(js, jnp.asarray(lev), params)
        ts, tg = TA.agc_block_coarse(ts, torch.as_tensor(lev), params)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(ts.gain.numpy(), np.asarray(js.gain))
        np.testing.assert_array_equal(ts.hangcount.numpy(),
                                      np.asarray(js.hangcount))


@pytest.mark.parametrize("n", [1, 2, 100, 960, 1001])
def test_one_pole_lowpass_close(n):
    rng = np.random.default_rng(n)
    x = np.abs(rng.standard_normal((4, n))).astype(np.float32) + 1.0
    y0 = rng.random(4).astype(np.float32)
    for alpha in (1e-4, 0.3):
        jl, jy = JI.one_pole_lowpass(jnp.asarray(y0), jnp.asarray(x), alpha)
        tl, ty = TI.one_pole_lowpass(torch.as_tensor(y0), torch.as_tensor(x),
                                     alpha)
        scale = float(np.abs(np.asarray(jy)).max())
        assert ty.dtype == torch.float32 and ty.shape == x.shape
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-6 * scale)
    # the recurrence itself, in float64, as the ground truth
    y, ref = float(y0[0]), []
    for v in x[0].astype(np.float64):
        y += 0.3 * (v - y)
        ref.append(y)
    np.testing.assert_allclose(ty.numpy()[0], ref, rtol=1e-6)


def test_dc_block_is_one_pole_on_axis():
    x = np.random.default_rng(2).random((5, 3)).astype(np.float32)
    jl, jy = JI.one_pole_lowpass(jnp.zeros(3), jnp.asarray(x), 0.1, axis=0)
    tl, ty = TI.one_pole_lowpass(torch.zeros(3), torch.as_tensor(x), 0.1,
                                 axis=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-7)
    dl, dy = TI.dc_block(torch.zeros(3), torch.as_tensor(x.T), 0.1)
    np.testing.assert_array_equal(dy.numpy(), ty.numpy().T)


@pytest.mark.parametrize("log_dec,thresh,dtype", [
    (5, 8, np.complex64), (3, 1, np.float32), (2, 8, np.float32)])
def test_hb_cascade_close_over_blocks(log_dec, thresh, dtype):
    np.testing.assert_array_equal(TD.hb15_coeffs(), JD.hb15_coeffs())
    rng = np.random.default_rng(log_dec)
    jst = JD.cascade_init(log_dec, thresh, dtype=dtype, batch_shape=(3,))
    tst = TD.cascade_init(log_dec, thresh,
                          dtype=torch.complex64 if dtype == np.complex64
                          else torch.float32, batch_shape=(3,), device="cpu")
    assert [tuple(s.shape) for s in tst] == [s.shape for s in jst]
    for _ in range(4):
        x = rng.standard_normal((3, 960))
        if dtype == np.complex64:
            x = x + 1j * rng.standard_normal((3, 960))
        x = x.astype(dtype)
        jst, jy = JD.hb_cascade(jst, jnp.asarray(x), log_dec, thresh)
        tst, ty = TD.hb_cascade(tst, torch.as_tensor(x), log_dec, thresh)
        jy = np.asarray(jy)
        assert ty.shape == jy.shape and ty.numpy().dtype == jy.dtype
        np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                                   atol=1e-6 * np.abs(jy).max())
        for a, b in zip(tst, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_odd_block_raises_like_jax():
    with pytest.raises(ValueError, match="even block"):
        JD.hb15_block(jnp.zeros(14), jnp.zeros(9))
    with pytest.raises(ValueError, match="even block"):
        TD.hb15_block(torch.zeros(14), torch.zeros(9))
