"""Parity of the port's single receiver (``models/receiver.py``) and noise
estimate (``models/noise.py``) against the JAX package on the CPU.

Every receiver case starts the port from the JAX ``Receiver``'s own state
(unpacked from its real-dtype jit boundary and carried through
``interop.state_from_jax``) and feeds both the same numpy-seeded blocks at
the reference ``radio`` defaults: 192 kHz in, 48 kHz out, L = 3840,
M = 4353 (N = 8192).

Tolerances, with their reasons:

- ``passband_mask``: bit-equal (numpy on both sides).
- ``compute_n0``, ``n0``, ``if_power``: rtol 1e-5.  They are sums over up
  to N float32 bins, in another order than XLA's, of spectra from another
  FFT library.  ``psd128`` (bin maxima): rtol 1e-5 plus 1e-9 of the peak
  bin's power, since an FFT's rounding error is a fraction of the whole
  spectrum's norm.
- FM audio: max |diff| <= 1e-5 and RMS diff <= 1e-6 (full scale 1.0), as
  tests/test_torch_fm.py: the discriminator output is an angle.
- AM, linear and PLL audio: the PARITY.md #9 bounds on int16 PCM (<= 8 LSB,
  difference RMS <= -85 dBFS) from the second block on: the AGC feeds
  float32 rounding back, and in the first block from a cold start it
  magnifies the FFT libraries' rounding (ROADMAP §3).
- the LO2 and Doppler NCO words, the ``set_freq`` return values, the AGC
  hang counts and the PLL's lock state: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ka9q_sdr_tpu.models import noise as JN
from ka9q_sdr_tpu.models import receiver as JR
from ka9q_sdr_tpu.ops.packing import tree_r2c
from ka9q_sdr_tpu_torch.interop import state_from_jax, state_to_numpy
from ka9q_sdr_tpu_torch.models import noise as TN
from ka9q_sdr_tpu_torch.models import receiver as TR

torch.set_num_threads(1)

FS, L = 192000, 3840
TUNE = 30000.0
BIN = 48000.0 / 65536                 # the PLL search bin, Hz


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(rx):
    return _np(tree_r2c(rx.state, rx._template))


def _pair(mode):
    """A JAX Receiver and a port Receiver that took over its state."""
    jrx = JR.Receiver(JR.make_receiver_config(mode, samprate=FS))
    trx = TR.Receiver(TR.make_receiver_config(mode, samprate=FS),
                      device="cpu")
    np.testing.assert_array_equal(trx.cfg.response, jrx.cfg.response)
    np.testing.assert_array_equal(trx.cfg.n0_mask, jrx.cfg.n0_mask)
    trx.state = state_from_jax(_jax_state(jrx), device="cpu")
    return jrx, trx


def _signal(kind, b, rng, n=L):
    """Block b of a test signal around TUNE plus complex noise."""
    t = (b * n + np.arange(n)) / FS
    x = 0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    if kind == "fm":          # 1 kHz audio at 3 kHz deviation
        ph = 3.0 * np.sin(2 * np.pi * 1000 * t)
        x = x + 0.3 * np.exp(1j * (2 * np.pi * TUNE * t + ph))
    elif kind == "am":        # 400 Hz at depth 0.5
        env = 1.0 + 0.5 * np.sin(2 * np.pi * 400 * t)
        x = x + 0.3 * env * np.exp(2j * np.pi * TUNE * t)
    elif kind == "cam":       # AM on a carrier 37 PLL bins off
        env = 1.0 + 0.3 * np.sin(2 * np.pi * 400 * t)
        x = x + 0.3 * env * np.exp(2j * np.pi * (TUNE + 37 * BIN) * t)
    else:                     # tones at these offsets from TUNE, Hz
        for off in kind:
            x = x + 0.1 * np.exp(2j * np.pi * (TUNE + off) * t)
    return x.astype(np.complex64)


def _pcm(a):
    return np.clip(np.asarray(a) * 32767.0, -32768, 32767).astype(np.int64)


def assert_pcm_close(a, b):
    """PARITY.md #9 on int16 PCM: <= 8 LSB, difference RMS <= -85 dBFS."""
    d = _pcm(a) - _pcm(b)
    assert np.abs(d).max() <= 8, np.abs(d).max()
    rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
    assert rms <= 10 ** (-85 / 20), rms


def assert_audio_close(mode, ta, ja, b):
    ta, ja = np.asarray(ta), np.asarray(ja)
    assert ta.shape == ja.shape and ta.dtype == ja.dtype == np.float32
    if mode in ("FM", "FMF"):
        d = ta.astype(np.float64) - ja
        assert np.abs(d).max() <= 1e-5 and np.sqrt(np.mean(d ** 2)) <= 1e-6
    elif b >= 1:
        assert_pcm_close(ta, ja)


def assert_diag_close(td, jd):
    for name in ("n0", "if_power"):
        np.testing.assert_allclose(np.asarray(td[name]),
                                   np.asarray(jd[name]), rtol=1e-5,
                                   err_msg=name)
    # an FFT's rounding error is a fraction of the whole spectrum's norm, so
    # a noise bin 60 dB under the peak carries it as relative error: rtol
    # 1e-5 per bin, plus 1e-9 of the peak bin's power
    j = np.asarray(jd["psd128"])
    np.testing.assert_allclose(np.asarray(td["psd128"]), j, rtol=1e-5,
                               atol=1e-9 * j.max(), err_msg="psd128")


def _cycles(word, resid):
    """A fixed-point word plus its float residual, in cycles (float64)."""
    return np.asarray(word, np.float64) / 2.0**32 + np.asarray(resid,
                                                                np.float64)


def assert_oscs_equal(ts, js, swept=False):
    """LO2 and Doppler NCO words exact.  A swept Doppler NCO is compared as
    phase and frequency in cycles instead: inside a jit fusion XLA's CPU
    backend contracts its ``freq_resid + n * rate`` into a fused
    multiply-add, one float32 ulp from eager JAX, which the port matches
    bit for bit (ROADMAP §3).  Bounds as tests/test_torch_bank.py's swept
    channel: 1e-9 cycles/sample of frequency, 2e-5 cycles of phase."""
    for osc in ("lo2",) if swept else ("lo2", "doppler"):
        for field, a, b in zip(getattr(ts, osc)._fields, getattr(ts, osc),
                               getattr(js, osc)):
            assert a.dtype == b.dtype, (osc, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{osc}.{field}")
    if swept:
        t, j = ts.doppler, js.doppler
        dphase = (_cycles(t.phase, t.phase_resid)
                  - _cycles(j.phase, j.phase_resid))
        assert np.abs(dphase - np.round(dphase)).max() <= 2e-5
        dfreq = _cycles(t.freq, t.freq_resid) - _cycles(j.freq, j.freq_resid)
        assert np.abs(dfreq - np.round(dfreq)).max() <= 1e-9
        np.testing.assert_array_equal(t.rate, j.rate)


def assert_discrete_equal(ts, js, swept=False):
    assert_oscs_equal(ts, js, swept)
    d, jd = ts.demod, js.demod
    if hasattr(jd, "agc"):
        np.testing.assert_array_equal(d.agc.hangcount, jd.agc.hangcount)
    if hasattr(jd, "pll_lock"):
        for name in ("pll_lock", "lock_count", "fft_samples"):
            np.testing.assert_array_equal(getattr(d, name), getattr(jd, name))
    if hasattr(jd, "snr_below"):
        np.testing.assert_array_equal(d.snr_below, jd.snr_below)


def _run(jrx, trx, mode, kind, blocks, rng):
    """`blocks` blocks through both receivers, compared block by block."""
    audio = []
    for b in range(blocks):
        x = _signal(kind, b, rng)
        ja, jd = jrx.process(x)
        ta, td = trx.process(x)
        assert_audio_close(mode, ta, ja, b)
        assert_diag_close(td, jd)
        assert_discrete_equal(state_to_numpy(trx.state), _jax_state(jrx))
        audio.append(ta.numpy())
    return np.concatenate(audio)


def _tone_hz(a, rate=48000.0):
    seg = a[len(a) // 2:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    spec[:5] = 0.0
    return np.argmax(spec) * rate / len(seg)


@pytest.mark.parametrize("N,fs,low,high", [
    (8192, 192000, -5000.0, 5000.0),
    (8192, 192000, 0.0, 3000.0),
    (4096, 48000, -3000.0, -100.0),
    (1 << 20, 24.576e6, 50.0, 2700.0),
])
def test_passband_mask_bit_equal(N, fs, low, high):
    t, j = TN.passband_mask(N, fs, low, high), JN.passband_mask(N, fs, low,
                                                                  high)
    assert t.dtype == j.dtype == bool
    np.testing.assert_array_equal(t, j)


def test_compute_n0():
    """Noise spectra with strong signal bins inside and outside the
    passband (the 3 dB second pass drops the outside ones), one row with
    no bins outside the passband at all."""
    rng = np.random.default_rng(3)
    N, fs = 8192, 192000.0
    mask = JN.passband_mask(N, fs, -5000.0, 5000.0)
    fd = (rng.standard_normal((3, N)) + 1j * rng.standard_normal((3, N)))
    fd[:, [3, 40, 1000, 5000]] *= 300.0          # signals
    fd = fd.astype(np.complex64)
    for row, m in ((fd[0], mask), (fd[1], ~mask), (fd[2], np.ones(N, bool))):
        want = np.asarray(JN.compute_n0(jnp.asarray(row), jnp.asarray(m), fs))
        got = TN.compute_n0(torch.as_tensor(row), torch.as_tensor(m), fs)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # batched over a leading axis, row by row as the JAX function
    got = TN.compute_n0(torch.as_tensor(fd), torch.as_tensor(mask), fs)
    want = [np.asarray(JN.compute_n0(jnp.asarray(r), jnp.asarray(mask), fs))
            for r in fd]
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-5)


MODES = [
    ("FM", "fm", 6, 1000.0),
    ("FMF", "fm", 6, 1000.0),
    ("AM", "am", 8, 400.0),
    ("USB", (1000.0,), 6, 1000.0),
    ("LSB", (-1000.0,), 6, 1000.0),
    ("CWU", (0.0,), 6, 700.0),
    ("IQ", (1000.0,), 4, None),
    ("CAM", "cam", 40, None),
    ("ISB", (1000.0, -1500.0), 6, None),
]


@pytest.mark.parametrize("mode,kind,blocks,tone", MODES,
                         ids=[m[0] for m in MODES])
def test_receiver_mode(mode, kind, blocks, tone):
    jrx, trx = _pair(mode)
    for rx in (jrx, trx):
        assert rx.set_freq(TUNE) is None and rx.second_lo == -TUNE
    audio = _run(jrx, trx, mode, kind, blocks, np.random.default_rng(11))
    if tone is not None:
        assert abs(_tone_hz(audio) - tone) < 15.0
    ts = state_to_numpy(trx.state)
    if mode == "CAM":      # the first acquisition (block 35) found the bin
        assert abs(ts.demod.delta_f - 37 * BIN) <= BIN
        np.testing.assert_array_equal(ts.demod.delta_f,
                                      _jax_state(jrx).demod.delta_f)
    if mode in ("IQ", "ISB"):
        assert audio.shape == (blocks * 960, 2)


def test_receiver_control_plane():
    """set_freq (LO2 absorbs the retune, or LO1 must move), update_first_lo,
    gain, Doppler, then set_filter, set_shift, set_mode, set_options and
    set_blocksize, each followed by blocks held against JAX."""
    jrx, trx = _pair("USB")
    rng = np.random.default_rng(5)
    _run(jrx, trx, "USB", (1000.0,), 2, rng)
    for f, lo2 in ((TUNE + 2000.0, float("nan")), (150e3, float("nan")),
                   (TUNE, 25000.0), (1.2e6, float("nan"))):
        assert trx.set_freq(f, lo2) == jrx.set_freq(f, lo2)
        assert trx.second_lo == jrx.second_lo
        assert_oscs_equal(state_to_numpy(trx.state), _jax_state(jrx))
    for rx in (jrx, trx):
        rx.update_first_lo(1.2e6 + 10.0)
        assert rx.set_freq(1.2e6 + TUNE) is None
        rx.set_gain_factor(1.5)
        rx.set_doppler(35.0, 0.0)
    assert dataclasses.astuple(trx.sdr) == dataclasses.astuple(jrx.sdr)
    assert (trx.tune_freq, trx.second_lo) == (jrx.tune_freq, jrx.second_lo)
    assert_oscs_equal(state_to_numpy(trx.state), _jax_state(jrx))
    # LO1 sits 10 Hz up, so a tone at IF TUNE + 990 Hz lands at 1 kHz
    edits = [
        ("set_filter", dict(low=200.0, high=2700.0, kaiser_beta=5.0)),
        ("set_shift", dict(shift_hz=300.0)),
        ("set_mode", dict(mode="LSB")),
        ("set_options", dict(isb=True)),
        ("set_mode", dict(mode="FM")),
        ("set_filter", dict(low=-6000.0, high=6000.0)),
        ("set_blocksize", dict(L=1920)),
        ("set_mode", dict(mode="AM")),
        ("set_doppler", dict(freq=35.0, rate=-2.0)),   # a sweep
    ]
    n, b = L, 2
    for name, kw in edits:
        for rx in (jrx, trx):
            getattr(rx, name)(**kw)
        swept = name == "set_doppler"
        assert dataclasses.astuple(trx.cfg.mode) == \
            dataclasses.astuple(jrx.cfg.mode)
        np.testing.assert_array_equal(trx.cfg.response, jrx.cfg.response)
        np.testing.assert_array_equal(trx.cfg.n0_mask, jrx.cfg.n0_mask)
        if trx.cfg.mode.demod == "FM":
            assert trx.cfg.demod_cfg.gain == jrx.cfg.demod_cfg.gain
        if name == "set_filter":
            # the JAX Receiver's jitted step keeps the config it was built
            # with, so its set_filter's new FM gain never reaches the audio
            # (ROADMAP §3); the port's step reads the current config.  Hold
            # the port to what the JAX set_filter means: rebuild its step.
            jrx._step = jax.jit(JR.receiver_step_packed(jrx.cfg,
                                                        jrx._template))
        n = kw.get("L", n)
        kind = "fm" if trx.cfg.mode.demod == "FM" else (990.0, -1510.0)
        # an edit restarts or retunes a feedback loop: the PCM bounds hold
        # from the second block after it, the FM float bound from the first
        for i in range(3):
            x = _signal(kind, b, rng, n=n)
            ja, jd = jrx.process(x)
            ta, td = trx.process(x)
            assert_audio_close(trx.cfg.mode.demod, ta, ja, i)
            assert_diag_close(td, jd)
            assert_discrete_equal(state_to_numpy(trx.state), _jax_state(jrx),
                                  swept)
            b += 1
    assert trx.state.overlap.shape == (trx.cfg.master.M - 1,) == (1920,)


def test_offline_and_scan_match_process_and_jax():
    """process_offline and receiver_scan equal a process loop on the port,
    and both match the JAX package's process_offline."""
    rng = np.random.default_rng(9)
    n_blocks = 5
    x = np.stack([_signal((1000.0,), b, rng) for b in range(n_blocks)])
    x16 = np.empty((n_blocks, L, 2), np.int16)
    x16[..., 0] = np.clip(x.real * 32767, -32768, 32767)
    x16[..., 1] = np.clip(x.imag * 32767, -32768, 32767)
    jrx, trx = _pair("USB")
    for rx in (jrx, trx):
        rx.set_freq(TUNE)
    s0 = trx.state
    want = jrx.process_offline(x16)
    got = trx.process_offline(x16)
    assert got.shape == want.shape == (n_blocks, 960)
    blocks = torch.as_tensor(x16).to(torch.float32) * float(
        np.float32(TR.SCALE16))
    blocks = torch.complex(blocks[..., 0], blocks[..., 1])
    _, scan = TR.receiver_scan(trx.cfg, s0, blocks)
    trx.state = s0
    loop = torch.stack([trx.process(blk)[0] for blk in blocks])
    assert torch.equal(got, loop) and torch.equal(scan, loop)
    for b in range(1, n_blocks):
        assert_pcm_close(got[b].numpy(), want[b])


def test_batched_receiver():
    """receiver_init(cfg, (2,)) and receiver_step on two independent rows
    (two signals), against the JAX receiver_step under jax.vmap."""
    jcfg = JR.make_receiver_config("FM", samprate=FS)
    tcfg = TR.make_receiver_config("FM", samprate=FS).to("cpu")
    js = JR.receiver_init(jcfg, (2,))
    ts = TR.receiver_init(tcfg, (2,), device="cpu")
    tl = jax.tree_util.tree_leaves(state_to_numpy(ts))
    jl = jax.tree_util.tree_leaves(_np(js))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    js = js._replace(lo2=jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v, (2,)), JR.set_osc(js.lo2, -TUNE / FS)))
    ts = ts._replace(lo2=TR.set_osc(ts.lo2, -TUNE / FS))
    step = jax.jit(jax.vmap(lambda s, x: JR.receiver_step(jcfg, s, x)))
    rng = np.random.default_rng(2)
    for b in range(4):
        x = np.stack([_signal("fm", b, rng), _signal((700.0,), b, rng)])
        js, ja, jd = step(js, jnp.asarray(x))
        ts, ta, td = TR.receiver_step(tcfg, ts, torch.as_tensor(x))
        assert ta.shape == (2, 960)
        assert_audio_close("FM", ta, ja, b)
        assert_diag_close(td, jd)
        assert_oscs_equal(state_to_numpy(ts), _np(js))
        np.testing.assert_array_equal(td["squelch_open"].numpy(),
                                      np.asarray(jd["squelch_open"]))
