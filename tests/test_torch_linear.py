"""Parity of the port's linear demodulator (and the AM demodulator) against
the JAX package on the CPU, block by block from one initial state.

Baseband is made with numpy from a fixed seed at 48 kHz in 960-sample
blocks (the bank's per-channel block).  The PLL cases run past the first
acquisition (block 35 for CAM's 2048-sample ring at acq_decim 32, block
34 for DSB's 4096-sample ring at acq_decim 16) with a 0.2 s lock time, so
the lock detector also flips inside the run.

Tolerances, with their reasons:

- discrete state (``pll_lock``, ``lock_count``, ``fft_samples``,
  ``delta_f``, the AGC hang count): exact.  ``delta_f`` is a bin index
  times the bin size; the carriers sit on bin centres, far from a tie.
- audio: the PARITY.md #9 feedback-loop bounds on int16 PCM, at most 8 LSB
  apart and a difference of at most -85 dBFS RMS.  JAX runs the loop
  jitted, where XLA may contract a*b+c into one rounding; the AGC and the
  PLL feed such ulps back.
- float state: within 1e-4 of each leaf's own scale (phase words of the
  PLL oscillators compared as cycles).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ka9q_sdr_tpu.models import demod_am as JAM
from ka9q_sdr_tpu.models import demod_linear as JL
from ka9q_sdr_tpu_torch.interop import state_from_jax, state_to_numpy
from ka9q_sdr_tpu_torch.models import demod_am as TAM
from ka9q_sdr_tpu_torch.models import demod_linear as TL

torch.set_num_threads(1)

FS, N = 48000.0, 960
BIN = FS / JL.PLL_FFT_SIZE          # 0.732421875 Hz


def pcm(a):
    return np.clip(np.asarray(a) * 32767.0, -32768, 32767).astype(np.int16)


def assert_parity9(a, b):
    """PARITY.md #9 on int16 PCM: <= 8 LSB, difference RMS <= -85 dBFS."""
    d = pcm(a).astype(np.int64) - pcm(b).astype(np.int64)
    assert np.abs(d).max() <= 8, np.abs(d).max()
    rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
    assert rms <= 10 ** (-85 / 20), rms


def _baseband(kind, n_blocks, seed=3):
    """(n_blocks, 4, N) complex64 baseband: three signal channels, one
    noise-only channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * N) / FS
    if kind == "cam":                  # AM carriers at bin centres
        offs = (37 * BIN, -56 * BIN, 17 * BIN)
        mod = 1.0 + 0.5 * np.cos(2 * np.pi * 1000 * t)
    elif kind == "dsb":                # suppressed carrier; 2*off on a bin
        offs = (45 * BIN / 2, -101 * BIN / 2, 19 * BIN / 2)
        mod = np.cos(2 * np.pi * 500 * t)
    else:                              # SSB/CW/IQ: tones
        offs = (1000.0, 600.0, -1500.0)
        mod = np.ones_like(t)
    x = 0.01 * (rng.standard_normal((4, t.size))
                + 1j * rng.standard_normal((4, t.size)))
    for c, f in enumerate(offs):
        x[c] += 0.1 * mod * np.exp(1j * (2 * np.pi * f * t + 0.7 * c))
    return x.astype(np.complex64).reshape(4, n_blocks, N).transpose(1, 0, 2), \
        offs


def _cycles(word, resid):
    return np.asarray(word, np.float64) / 2.0**32 + np.asarray(resid,
                                                                np.float64)


def _assert_float_state(ts, js):
    """Float leaves within 1e-4 of their scale; oscillators as cycles."""
    for name in ("integrator", "foffset", "snr"):
        a, b = getattr(ts, name), getattr(js, name)
        np.testing.assert_allclose(a, b, rtol=0, equal_nan=True,
                                   atol=1e-4 * np.max(np.abs(np.nan_to_num(b)),
                                                      initial=1.0))
    np.testing.assert_allclose(ts.agc.gain, js.agc.gain, rtol=1e-4)
    if js.fft_ring is not None:
        np.testing.assert_allclose(ts.fft_ring, js.fft_ring, rtol=0,
                                   atol=1e-4 * np.abs(js.fft_ring).max())
    for osc in ("fine", "coarse", "shift"):
        a, b = getattr(ts, osc), getattr(js, osc)
        dp = _cycles(a.phase, a.phase_resid) - _cycles(b.phase, b.phase_resid)
        assert np.abs(dp - np.round(dp)).max() <= 1e-4
        df = _cycles(a.freq, a.freq_resid) - _cycles(b.freq, b.freq_resid)
        assert np.abs(df - np.round(df)).max() <= 1e-9


# name: (make kwargs, signal, blocks)
_CASES = {
    "CAM": (dict(recovery_rate_db_s=50.0, hangtime_s=0.0, pll=True,
                 channels=1, lock_time=0.2), "cam", 60),
    "DSB": (dict(recovery_rate_db_s=6.0, hangtime_s=1.1, pll=True,
                 square=True, channels=1, lock_time=0.2), "dsb", 62),
    "USB": (dict(recovery_rate_db_s=6.0, hangtime_s=1.1, channels=1),
            "tone", 6),
    "CWU": (dict(recovery_rate_db_s=20.0, hangtime_s=0.2, channels=1,
                 shift_freq=700.0 / FS), "tone", 6),
    "IQ": (dict(recovery_rate_db_s=6.0, hangtime_s=1.1, channels=2),
           "tone", 6),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_linear_demod_matches_jax(name):
    kw, kind, n_blocks = _CASES[name]
    jcfg = JL.LinearConfig.make(FS, N, **kw)
    tcfg = TL.LinearConfig.make(FS, N, **kw)
    assert tuple(tcfg) == tuple(jcfg)
    for prop in ("integrator_gain", "prop_gain", "lock_limit", "binsize",
                 "ring_size", "search_bins"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop)
    js = JL.linear_init(jcfg, (4,))
    ts = TL.linear_init(tcfg, (4,), device="cpu")
    # the port's own init agrees with the JAX package's leaf for leaf
    jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
    for a, b in zip(jax.tree_util.tree_leaves(tn), jax.tree_util.tree_leaves(jn)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ts = state_from_jax(jn, device="cpu")
    bb, offs = _baseband(kind, n_blocks)
    step = jax.jit(lambda s, x: JL.linear_demod(jcfg, s, x))
    locks = []
    for blk in range(n_blocks):
        js, ja, jd = step(js, jnp.asarray(bb[blk]))
        ts, ta, td = TL.linear_demod(tcfg, ts, torch.as_tensor(bb[blk]))
        assert ta.shape == ja.shape and ta.dtype == torch.float32
        assert_parity9(ta.numpy(), ja)
        jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
        for name_ in ("pll_lock", "lock_count", "fft_samples", "delta_f"):
            np.testing.assert_array_equal(getattr(tn, name_),
                                          getattr(jn, name_))
        np.testing.assert_array_equal(tn.agc.hangcount, jn.agc.hangcount)
        np.testing.assert_array_equal(td["pll_lock"].numpy(),
                                      np.asarray(jd["pll_lock"]))
        locks.append(tn.pll_lock.copy())
    _assert_float_state(tn, jn)
    if jcfg.pll:
        # acquired every signal channel within a bin, locked them, and
        # left the noise-only channel unlocked
        np.testing.assert_allclose(tn.delta_f[:3], offs, atol=BIN)
        assert locks[-1].tolist() == [True, True, True, False]
        assert not locks[30].any()
    else:
        assert not np.asarray(jn.pll_lock).any()


def test_am_demod_matches_jax():
    jcfg = JAM.AMConfig.make(FS, recovery_rate_db_s=50.0)
    tcfg = TAM.AMConfig.make(FS, recovery_rate_db_s=50.0)
    assert tuple(tcfg) == tuple(jcfg)
    js = JAM.am_init((4,))
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    tn0 = state_to_numpy(TAM.am_init((4,), device="cpu"))
    np.testing.assert_array_equal(tn0.agc.gain, np.asarray(js.agc.gain))
    bb, _ = _baseband("cam", 8, seed=11)
    step = jax.jit(lambda s, x: JAM.am_demod(jcfg, s, x))
    for blk in range(8):
        js, ja, jd = step(js, jnp.asarray(bb[blk]))
        ts, ta, td = TAM.am_demod(tcfg, ts, torch.as_tensor(bb[blk]))
        assert_parity9(ta.numpy(), ja)
        np.testing.assert_allclose(td["bb_power"].numpy(),
                                   np.asarray(jd["bb_power"]), rtol=1e-5)
    np.testing.assert_allclose(ts.dc.numpy(), np.asarray(js.dc), rtol=1e-5)
    np.testing.assert_array_equal(ts.agc.hangcount.numpy(),
                                  np.asarray(js.agc.hangcount))
    # the 1 kHz modulation comes out on the signal channels
    spec = np.abs(np.fft.rfft(ta.numpy()[0]))
    spec[0] = 0
    assert abs(np.argmax(spec) * FS / N - 1000.0) <= FS / N


def test_linear_init_guards_match_jax():
    # not a power of two; does not divide the block; ring too short
    for block, d in ((N, 3), (N, 1024), (1024, 128)):
        jcfg = JL.LinearConfig.make(FS, block, pll=True, acq_decim=d)
        tcfg = TL.LinearConfig.make(FS, block, pll=True, acq_decim=d)
        with pytest.raises(ValueError) as je:
            JL.linear_init(jcfg, (2,))
        with pytest.raises(ValueError) as te:
            TL.linear_init(tcfg, (2,), device="cpu")
        assert str(te.value) == str(je.value)
