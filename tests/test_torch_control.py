"""The port's live bank control against the JAX package on the CPU:
retune, Doppler steer with a sweep across ``bank_recenter`` hops, the
filter swap, and the demod-row reset, each applied to one state carried
through ``interop``.

Tolerances: k, r, dr, the NCO words and residuals, the response and the
spliced demod rows are exact, and a rejected command raises the same
ValueError.  Blocks in between run the part of bank_step that moves the
tuned state (master FFT, ``bank_recenter``, ``bank_channelize``) through the
JAX package eagerly, op by op: jitted, XLA's CPU backend contracts the
swept NCO's ``freq_resid + n * rate`` into a fused multiply-add, one
float32 ulp away (ROADMAP §3), while eager JAX rounds as the port does.
The demodulator does not touch the tuned state and is left out.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ka9q_sdr_tpu.models import bank as JB
from ka9q_sdr_tpu.ops import fftfilt as JF
from ka9q_sdr_tpu.ops.packing import tree_r2c
from ka9q_sdr_tpu_torch.interop import state_from_jax, state_to_numpy
from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.models.demod_linear import linear_init
from ka9q_sdr_tpu_torch.ops import fftfilt as TF

torch.set_num_threads(1)

FS, LW, M, B = 1.536e6, 30720, 34817, 8
FREQS = list(np.linspace(-0.45 * FS, 0.45 * FS, B, endpoint=False))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tuned_equal(ts, js):
    tn, jn = state_to_numpy(ts), _np(js)
    for name in ("k", "r", "dr"):
        np.testing.assert_array_equal(getattr(tn, name), getattr(jn, name))
    for field, a, b in zip(tn.nco._fields, tn.nco, jn.nco):
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(tn.resp, jn.resp)


def _tuned_step(jcfg, js, tcfg, ts, x):
    """bank_step without the demodulator, on both packages."""
    overlap, fd = JF.master_execute(jcfg.master, js.overlap, jnp.asarray(x))
    js = JB.bank_recenter(jcfg, js)
    r, nco, _ = JB.bank_channelize(jcfg, js, fd)
    js = js._replace(overlap=overlap, r=r, nco=nco)
    overlap, fd = TF.master_execute(tcfg.master, ts.overlap,
                                    torch.as_tensor(x))
    ts = TB.bank_recenter(tcfg, ts)
    r, nco, _ = TB.bank_channelize(tcfg, ts, fd)
    return js, ts._replace(overlap=overlap, r=r, nco=nco)


def test_tune_and_swept_doppler_across_recenter_hops():
    """tune, then Doppler steers whose sweeps hop k every block or two,
    then a retune of a swept channel (which reads the live, hopped k), all
    between real blocks."""
    jcfg = JB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M)
    tcfg = TB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M).to("cpu")
    js = JB.bank_init(jcfg, FREQS)
    ts = state_from_jax(_np(js), device="cpu")
    rng = np.random.default_rng(8)
    k0 = np.asarray(js.k).copy()
    ops = [
        ("tune", 2, FREQS[2] + 12_345.6),
        ("doppler", 5, FREQS[5], -31.0, 4000.0),
        ("doppler", 1, FREQS[1], 250.0, -2500.0),
        ("step",), ("step",),
        ("tune", 5, FREQS[5] - 7_000.25),        # swept channel, hopped k
        ("step",),
        ("doppler", 2, FREQS[2] + 12_345.6, 0.0, 0.0),   # stop
        ("tune", 0, -0.5 * FS),                  # the span's edge
        ("step",), ("step",),
    ]
    for op in ops:
        if op[0] == "tune":
            js = JB.bank_tune(jcfg, js, op[1], op[2])
            ts = TB.bank_tune(tcfg, ts, op[1], op[2])
        elif op[0] == "doppler":
            js = JB.bank_set_doppler(jcfg, js, *op[1:3], doppler_hz=op[3],
                                     rate_hz_s=op[4])
            ts = TB.bank_set_doppler(tcfg, ts, *op[1:3], doppler_hz=op[3],
                                     rate_hz_s=op[4])
        else:
            x = (0.01 * (rng.standard_normal(LW)
                         + 1j * rng.standard_normal(LW))).astype(np.complex64)
            js, ts = _tuned_step(jcfg, js, tcfg, ts, x)
        _assert_tuned_equal(ts, js)
    hops = np.asarray(js.k).astype(np.int64) - k0
    assert hops[1] != 0 and hops[5] != 0


def test_rejected_commands_raise_alike():
    jcfg = JB.make_bank_config(B, "USB", samprate=FS, L=LW, M=M)
    tcfg = TB.make_bank_config(B, "USB", samprate=FS, L=LW, M=M).to("cpu")
    js = JB.bank_init(jcfg, FREQS)
    ts = state_from_jax(_np(js), device="cpu")
    calls = [
        (JB.bank_tune, TB.bank_tune, (js, 1, 1e300)),
        (JB.bank_tune, TB.bank_tune, (js, 1, float("nan"))),
        (JB.bank_tune, TB.bank_tune, (js, 1, 0.6 * FS)),
        (JB.bank_set_doppler, TB.bank_set_doppler, (js, 1, FREQS[1], 1e9)),
        (JB.bank_set_doppler, TB.bank_set_doppler,
         (js, 1, FREQS[1], 0.0, float("inf"))),
        (JB.swap_filter_response, TB.swap_filter_response,
         (js, -3000.0, 3000.0, 500.0)),
        (JB.swap_filter_response, TB.swap_filter_response,
         (js, float("nan"), 3000.0)),
    ]
    for jfn, tfn, args in calls:
        with pytest.raises(ValueError) as je:
            jfn(jcfg, *args)
        with pytest.raises(ValueError) as te:
            tfn(tcfg, ts, *args[1:])
        assert str(te.value) == str(je.value)
    # bank_init's span check, too
    with pytest.raises(ValueError) as je:
        JB.bank_init(jcfg, [0.0] * (B - 1) + [FS])
    with pytest.raises(ValueError) as te:
        TB.bank_init(tcfg, [0.0] * (B - 1) + [FS], device="cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("mode,edges", [("FM", (-5000.0, 5000.0, None)),
                                        ("ISB", (-3000.0, 2500.0, 6.0))])
def test_set_filter_swaps_the_response(mode, edges):
    jcfg = JB.make_bank_config(B, mode, samprate=FS, L=LW, M=M)
    tcfg = TB.make_bank_config(B, mode, samprate=FS, L=LW, M=M)
    jbank = JB.ChannelBank(jcfg, FREQS)
    tbank = TB.ChannelBank(tcfg, FREQS, device="cpu")
    low, high, beta = edges
    jbank.set_filter(low, high, kaiser_beta=beta)
    tbank.set_filter(low, high, kaiser_beta=beta)
    jresp = np.asarray(tree_r2c(jbank.state, jbank._template).resp)
    np.testing.assert_array_equal(tbank.state.resp.numpy(), jresp)
    np.testing.assert_array_equal(tbank.cfg.response, jbank.cfg.response)
    assert dataclasses.astuple(tbank.cfg.mode) == \
        dataclasses.astuple(jbank.cfg.mode)
    assert tbank.cfg.kaiser_beta == jbank.cfg.kaiser_beta
    if mode == "FM":
        assert tbank.cfg.demod_cfg.gain == jbank.cfg.demod_cfg.gain
    x = (np.random.default_rng(1).standard_normal((LW, 2)) * 300
         ).astype(np.int16)
    pcm, _ = tbank.process_i16_pcm(x)
    assert pcm.dtype == torch.int16
    assert torch.isfinite(tbank.state.demod.agc.gain if mode == "ISB"
                          else tbank.state.demod.lastaudio).all()


def test_channelbank_controls_and_steer_adapter():
    """ChannelBank.tune / set_doppler / steer_adapter on both packages."""
    jcfg = JB.make_bank_config(B, "CAM", samprate=FS, L=LW, M=M)
    tcfg = TB.make_bank_config(B, "CAM", samprate=FS, L=LW, M=M)
    jbank = JB.ChannelBank(jcfg, FREQS)
    tbank = TB.ChannelBank(tcfg, FREQS, device="cpu")
    for bank in (jbank, tbank):
        bank.tune(3, FREQS[3] + 1234.5)
        chan = bank.steer_adapter(3)
        assert chan.tune_freq == FREQS[3] + 1234.5
        chan.set_doppler(-45.0, 120.0)
        bank.set_doppler(6, 20.0, -300.0)
        with pytest.raises(ValueError):
            bank.tune(4, 1e300)
    assert tbank.freqs == jbank.freqs
    _assert_tuned_equal(tbank.state, tree_r2c(jbank.state, jbank._template))


def test_reset_demod_row_matches_jax():
    """A CAM bank's LinearState (with its tuple of half-band states) after
    a few blocks; resetting one row splices that row from a fresh state and
    leaves every other row and the shared leaves alone."""
    jcfg = JB.make_bank_config(B, "CAM", samprate=FS, L=LW, M=M)
    tcfg = TB.make_bank_config(B, "CAM", samprate=FS, L=LW, M=M)
    jbank = JB.ChannelBank(jcfg, FREQS)
    rng = np.random.default_rng(4)
    for _ in range(3):
        jbank.process_i16_pcm((rng.standard_normal((LW, 2)) * 400
                               ).astype(np.int16))
    js = _np(tree_r2c(jbank.state, jbank._template))
    ts = state_from_jax(js, device="cpu")
    jfresh = _np(JB.bank_init(jcfg, FREQS).demod)
    tfresh = linear_init(tcfg.demod_cfg, (B,), device="cpu")
    jr = _np(JB.bank_reset_demod_row(js, jfresh, 5, B))
    tr = state_to_numpy(TB.bank_reset_demod_row(ts, tfresh, 5, B))
    tl, jl = jax.tree_util.tree_leaves(tr), jax.tree_util.tree_leaves(jr)
    assert len(tl) == len(jl) > 20
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # row 5 is fresh, row 4 is not
    assert tr.demod.fft_samples[5] == 0 and tr.demod.fft_samples[4] > 0
    assert not np.asarray(tr.demod.fft_ring[5]).any()
