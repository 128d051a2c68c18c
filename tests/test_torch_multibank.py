"""The port's mixed-mode ``MultiBank`` and ``make_bank`` against the JAX
package on the CPU.

Geometry as tests/test_demods.py's MultiBank case: fs = 1.536 Msps,
L = 30720, M = 34817 (N = 65536, decimate 32; per channel N_dec 2048,
L_dec 960).  The parity case starts every group of the port from the JAX
MultiBank's own state (unpacked from its real-dtype jit boundary, carried
through ``interop.state_from_jax``) after one warm-up block, as
tests/test_torch_bank_modes.py does, and feeds both the same numpy-seeded
int16 blocks.

Tolerances, with their reasons:

- FM audio: max |diff| <= 1e-5 and RMS diff <= 1e-6 (full scale 1.0), as
  tests/test_torch_fm.py; squelch flags exact.
- AM, USB and CAM PCM: the PARITY.md #9 bounds (<= 8 LSB, difference RMS
  <= -85 dBFS): the AGC (and the PLL) feed float32 rounding back.
- k/r/dr, the NCO words, the responses, the AGC hang counts and the PLL's
  lock state: exact.
"""

import numpy as np
import pytest
import torch

import jax

from ka9q_sdr_tpu.models import bank as JB
from ka9q_sdr_tpu.ops.packing import tree_r2c
from ka9q_sdr_tpu_torch.interop import state_from_jax, state_to_numpy
from ka9q_sdr_tpu_torch.models import bank as TB

torch.set_num_threads(1)

FS, LW, M = 1.536e6, 30720, 34817
SCALE = np.float32(1.0 / 32767.0)       # the ingest scaling, as a multiply


def _tone_hz(a, rate=48000.0):
    seg = a[len(a) // 2:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    spec[:5] = 0.0
    return np.argmax(spec) * rate / len(seg)


def test_mixed_modes_share_fft():
    """FM + AM + USB groups demodulate concurrently off ONE wideband FFT;
    a quiet FM channel squelches (tests/test_demods.py's MultiBank case on
    the port), and every group's state holds the one overlap tensor."""
    groups = [("FM", [-300e3, -100e3]), ("AM", [150e3]), ("USB", [333e3])]
    mb = TB.MultiBank(groups, samprate=FS, L=LW, M=M, device="cpu")
    assert mb.group_real == [2, 1, 1]
    phase = 0.0
    buf = {0: [], 1: [], 2: []}
    for b in range(40):
        tt = (b * LW + np.arange(LW)) / FS
        inst = 3000 * np.cos(2 * np.pi * 1000 * tt)
        ph = np.cumsum(2 * np.pi * inst / FS) + phase
        phase = ph[-1]
        sig = 0.3 * np.exp(1j * (2 * np.pi * (-100e3) * tt + ph))
        sig = sig + 0.3 * (1 + 0.5 * np.sin(2 * np.pi * 400 * tt)) * np.exp(
            2j * np.pi * 150e3 * tt)
        sig = sig + 0.2 * np.exp(2j * np.pi * (333e3 + 700) * tt)
        outs = mb.process(sig.astype(np.complex64))
        if b >= 15:
            buf[0].append(outs[0][0][1].numpy())
            buf[1].append(outs[1][0][0].numpy())
            buf[2].append(outs[2][0][0].numpy())
    assert abs(_tone_hz(np.concatenate(buf[0])) - 1000) < 5
    assert abs(_tone_hz(np.concatenate(buf[1])) - 400) < 5
    assert abs(_tone_hz(np.concatenate(buf[2])) - 700) < 5
    sq = outs[0][1]["squelch_open"]
    assert bool(sq[1]) and not bool(sq[0])
    assert all(s.overlap is mb.states[0].overlap for s in mb.states)


def _i16_blocks(n_blocks, carriers, seed=6):
    """carriers: (freq Hz, kind): 'fm' (1 kHz at 3 kHz deviation), 'am'
    (1 kHz AM at depth 0.5) or 'tone'."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        t = (b * LW + np.arange(LW)) / FS
        sig = 0.003 * (rng.standard_normal(LW) + 1j * rng.standard_normal(LW))
        for j, (f, kind) in enumerate(carriers):
            if kind == "fm":
                ph = 3.0 * np.sin(2 * np.pi * 1000 * t)
                sig = sig + 0.1 * np.exp(1j * (2 * np.pi * f * t + ph))
            else:
                env = 1.0 + 0.5 * np.cos(2 * np.pi * 1000 * t) \
                    if kind == "am" else 1.0
                sig = sig + 0.1 * env * np.exp(1j * (2 * np.pi * f * t + j))
        x = np.empty((LW, 2), np.int16)
        x[:, 0] = np.clip(sig.real * 32767, -32768, 32767)
        x[:, 1] = np.clip(sig.imag * 32767, -32768, 32767)
        out.append(x)
    return out


def _jax_states(jmb):
    return [jax.tree_util.tree_map(np.asarray, tree_r2c(s, t))
            for s, t in zip(jmb.states, jmb._templates)]


def _assert_pcm_close(a, b):
    d = np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)
    assert np.abs(d).max() <= 8, np.abs(d).max()
    rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
    assert rms <= 10 ** (-85 / 20), rms


def _pcm(a):
    return np.clip(np.asarray(a) * 32767.0, -32768, 32767).astype(np.int16)


def _cycles(word, resid):
    """A fixed-point word plus its float residual, in cycles (float64)."""
    return np.asarray(word, np.float64) / 2.0**32 + np.asarray(resid,
                                                                np.float64)


def _assert_group_equal(mode, ts, js, tout, jout, swept=()):
    """One group's state and output, port against JAX.  The NCO of a
    `swept` row is compared as phase and frequency in cycles, with
    tests/test_torch_bank.py's bounds: inside a jit fusion XLA's CPU backend
    contracts the swept ``freq_resid + n * rate`` into a fused multiply-add,
    one float32 ulp from eager JAX, which the port matches (ROADMAP §3)."""
    for name in ("k", "r", "dr"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    rows = [i for i in range(len(ts.k)) if i not in swept]
    for a, b in zip(ts.nco, js.nco):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a[rows], b[rows])
    t, j = ts.nco, js.nco
    for i in swept:
        dphase = (_cycles(t.phase[i], t.phase_resid[i])
                  - _cycles(j.phase[i], j.phase_resid[i]))
        assert abs(dphase - np.round(dphase)) <= 2e-5
        dfreq = (_cycles(t.freq[i], t.freq_resid[i])
                 - _cycles(j.freq[i], j.freq_resid[i]))
        assert abs(dfreq - np.round(dfreq)) <= 1e-9
    np.testing.assert_array_equal(t.rate, j.rate)
    np.testing.assert_array_equal(ts.resp, js.resp)
    (ta, td), (ja, jd) = tout, jout
    ja = np.asarray(ja)
    assert ta.shape == ja.shape
    if mode == "FM":
        d = ta.numpy().astype(np.float64) - ja
        assert np.abs(d).max() <= 1e-5 and np.sqrt(np.mean(d ** 2)) <= 1e-6
        np.testing.assert_array_equal(td["squelch_open"].numpy(),
                                      np.asarray(jd["squelch_open"]))
        np.testing.assert_array_equal(ts.demod.snr_below, js.demod.snr_below)
    else:
        _assert_pcm_close(_pcm(ta.numpy()), _pcm(ja))
        np.testing.assert_array_equal(ts.demod.agc.hangcount,
                                      js.demod.agc.hangcount)
    if mode == "CAM":
        for name in ("pll_lock", "lock_count", "fft_samples", "delta_f"):
            np.testing.assert_array_equal(getattr(ts.demod, name),
                                          getattr(js.demod, name))


def test_multibank_matches_jax_through_live_control():
    """FM, USB and CAM groups from one JAX state; a retune, a Doppler sweep
    across k hops, a row re-commission (init_channel) and a filter swap,
    each on one group, with blocks between them.

    Both sides ingest the same scaled block: the JAX MultiBank takes packed
    float32 I/Q, the port its int16 (``process_i16``) and complex
    (``process``) ingest, which scale with the same float32 multiply."""
    modes = ("FM", "USB", "CAM")
    fr = list(np.linspace(-0.45 * FS, 0.45 * FS, 9, endpoint=False))
    groups = [(m, fr[3 * g:3 * g + 3]) for g, m in enumerate(modes)]
    carriers = [(fr[1], "fm"), (fr[3] + 1000.0, "tone"), (fr[5] + 700.0,
                "tone"), (fr[7] + 17 * 48000.0 / 65536, "am")]
    jmb = JB.MultiBank(groups, samprate=FS, L=LW, M=M)
    tmb = TB.MultiBank(groups, samprate=FS, L=LW, M=M, device="cpu")
    for tc, jc in zip(tmb.cfgs, jmb.cfgs):
        np.testing.assert_array_equal(tc.response, jc.response)
    blocks = _i16_blocks(14, carriers)
    packed = [x.astype(np.float32) * SCALE for x in blocks]
    jmb.process(packed[0])                           # warm-up
    states = [state_from_jax(s, device="cpu") for s in _jax_states(jmb)]
    tmb.states = [s._replace(overlap=states[0].overlap) for s in states]
    ops = {
        2: lambda mb: mb.tune(1, 0, fr[3] + 2500.0),
        3: lambda mb: mb.set_doppler(0, 2, 40.0, 6000.0),
        5: lambda mb: mb.init_channel(2, 1, fr[7]),
        6: lambda mb: mb.set_filter(1, -200.0, 3500.0, kaiser_beta=6.0),
        8: lambda mb: mb.set_doppler(0, 2, 0.0, 0.0),
    }
    k_fm = np.asarray(jmb.states[0].k).copy()
    for b in range(1, len(blocks)):
        if b == 8:                                   # before the stop
            assert (np.asarray(jmb.states[0].k) != k_fm).any()   # k hopped
        if b in ops:
            ops[b](jmb)
            ops[b](tmb)
            assert tmb.group_freqs == jmb.group_freqs
        jout = jmb.process(packed[b])
        tout = (tmb.process_i16(blocks[b]) if b % 2 else
                tmb.process(packed[b]))
        for g, (mode, ts, js, to, jo) in enumerate(zip(
                modes, [state_to_numpy(s) for s in tmb.states],
                _jax_states(jmb), tout, jout)):
            _assert_group_equal(mode, ts, js, to, jo,
                                swept=(2,) if g == 0 and b >= 3 else ())
    assert all(s.overlap is tmb.states[0].overlap for s in tmb.states)
    cam = state_to_numpy(tmb.states[2]).demod
    assert cam.fft_samples[1] < cam.fft_samples[0]       # row 1 respawned
    pcm = tmb.process_i16_pcm(blocks[-1])
    assert [p.dtype for p, _ in pcm] == [torch.int16] * 3


def test_master_mismatch_raises_alike(monkeypatch):
    """Groups whose master differs raise the same ValueError on both
    sides.  make_bank_config gives every group the bank's one (L, M), so
    the mismatch is forced on the second group's config."""
    def second_differs(real):
        calls = []

        def make(*a, **kw):
            calls.append(1)
            if len(calls) == 2:
                kw = dict(kw, L=kw["L"] - 1024, M=kw["M"] + 1024)
            return real(*a, **kw)
        return make

    groups = [("FM", [0.0]), ("USB", [1e5])]
    msgs = []
    for pkg, kw in ((JB, {}), (TB, {"device": "cpu"})):
        monkeypatch.setattr(pkg, "make_bank_config",
                            second_differs(pkg.make_bank_config))
        with pytest.raises(ValueError) as e:
            pkg.MultiBank(groups, samprate=FS, L=LW, M=M, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "share one master" in msgs[1]


@pytest.mark.parametrize("n,mode", [(8, "FM"), (5, "CAM")])
def test_make_bank_default_spread(n, mode):
    jb = JB.make_bank(n, mode, samprate=FS, L=LW, M=M)
    tb = TB.make_bank(n, mode, samprate=FS, L=LW, M=M, device="cpu")
    assert tb.freqs == jb.freqs
    assert min(tb.freqs) == -0.45 * FS and max(tb.freqs) < 0.45 * FS
    js = jax.tree_util.tree_map(np.asarray, tree_r2c(jb.state, jb._template))
    tl = jax.tree_util.tree_leaves(state_to_numpy(tb.state))
    jl = jax.tree_util.tree_leaves(js)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    freqs = [-1e5, 2e5]
    assert TB.make_bank(2, "AM", freqs, samprate=FS, L=LW, M=M,
                        device="cpu").freqs == freqs
