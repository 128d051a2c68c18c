"""The port's compiled steps (``utils/graphs.py``) and the host wrappers
that run on them, against the JAX package's jitted wrappers on the CPU.

On the CPU every wrapper runs its step eagerly through the same
static-state code the card captures: the state is the wrapper's own
tensors, written in place after each block, and live edits write into
them.  These tests hold that path to the JAX wrappers
(``ChannelBank.process_scan_i16`` and ``process_active``, a ``MultiBank``
through ``init_channel`` and an FM filter swap, ``Receiver.process_offline``
and live edits between blocks), check that what a call returned stays
intact while later blocks step, and check the helpers themselves.
``tests/test_torch_graphs_cuda.py`` holds the captured graphs against the
eager twin on the card.

Geometry as tests/test_torch_bank.py: 8 channels at fs = 1.536 Msps,
L = 30720, M = 34817 (N = 65536, decimate 32; per channel N_dec 2048,
L_dec 960); the receiver at radio's defaults (192 kHz, L 3840, M 4353).
Inputs are int16 blocks made with numpy from a fixed seed.  Each port
object starts from the JAX object's own state after one warm-up block.

Tolerances, with their reasons (as the tests of each wrapper):

- FM audio: max |diff| <= 1e-5 and RMS diff <= 1e-6 (full scale 1.0); FM
  PCM within 1 LSB: the port gathers bins directly where the JAX package
  takes its aligned chunk-row path, and the FFT libraries differ.
- AM, USB and CAM PCM: the PARITY.md #9 bounds (<= 8 LSB, difference RMS
  <= -85 dBFS): the AGC and the PLL feed float32 rounding back.
- k/r/dr, the NCO words, squelch counters, AGC hang counts, the PLL's lock
  state and the active-channel sets: exact.
- A scan against the same blocks stepped one at a time, on the port: bit
  for bit (the same operations in the same order).
"""

import numpy as np
import pytest
import torch

import jax

from ka9q_sdr_tpu.models import bank as JB
from ka9q_sdr_tpu.models import receiver as JR
from ka9q_sdr_tpu.ops.packing import tree_r2c
from ka9q_sdr_tpu_torch.interop import state_from_jax, state_to_numpy
from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.models import receiver as TR
from ka9q_sdr_tpu_torch.utils import graphs

torch.set_num_threads(1)

FS, LW, M, B = 1.536e6, 30720, 34817, 8
FREQS = list(np.linspace(-0.45 * FS, 0.45 * FS, B, endpoint=False))
FM_SIGNAL = (1, 3, 6)
BIN = 48000.0 / 65536                 # the PLL search bin, Hz
CAM_SIGNAL = {2: 37, 5: -21}          # channel: carrier offset in PLL bins
RX_FS, RX_L, RX_TUNE = 192000, 3840, 30000.0
K = 4                                 # blocks in a scan


def _i16(sig):
    x = np.empty(sig.shape + (2,), np.int16)
    x[..., 0] = np.clip(sig.real * 32767, -32768, 32767)
    x[..., 1] = np.clip(sig.imag * 32767, -32768, 32767)
    return x


def _blocks(n, kind, seed=5):
    """n int16 (LW, 2) blocks: FM carriers with 1 kHz audio and a 100 Hz PL
    tone on FM_SIGNAL ("fm"), or 1 kHz AM on carriers a few PLL bins off
    CAM_SIGNAL ("am"), over complex noise."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        t = (b * LW + np.arange(LW)) / FS
        sig = 0.003 * (rng.standard_normal(LW) + 1j * rng.standard_normal(LW))
        if kind == "fm":
            for j, ch in enumerate(FM_SIGNAL):
                ph = (3.0 * np.sin(2 * np.pi * 1000 * t + j)
                      + 5.0 * np.sin(2 * np.pi * 100.0 * t))
                sig = sig + 0.2 * np.exp(
                    1j * (2 * np.pi * (FREQS[ch] + 37.0 * j) * t + ph))
        else:
            for j, (ch, off) in enumerate(CAM_SIGNAL.items()):
                env = 1.0 + 0.5 * np.cos(2 * np.pi * 1000 * t)
                sig = sig + 0.1 * env * np.exp(
                    1j * (2 * np.pi * (FREQS[ch] + off * BIN) * t + j))
        out.append(_i16(sig))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(jbank):
    return _np(tree_r2c(jbank.state, jbank._template))


def assert_pcm_close(a, b, lsb=8):
    """PARITY.md #9 on int16 PCM (lsb=1: the FM bank's bound)."""
    d = np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)
    assert np.abs(d).max() <= lsb, np.abs(d).max()
    rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
    assert rms <= 10 ** (-85 / 20), rms


def assert_fm_audio_close(ta, ja):
    d = np.asarray(ta).astype(np.float64) - np.asarray(ja)
    assert np.abs(d).max() <= 1e-5 and np.sqrt(np.mean(d ** 2)) <= 1e-6


def _cycles(word, resid):
    """A fixed-point word plus its float residual, in cycles (float64)."""
    return np.asarray(word, np.float64) / 2.0**32 + np.asarray(resid,
                                                                np.float64)


def assert_discrete_equal(tn, jn, steered=()):
    """A bank state's exact leaves, port (numpy) against JAX.  The NCO of a
    `steered` row (its frequency all in the float residual) is compared as
    phase and frequency in cycles, with tests/test_torch_bank.py's bounds:
    inside a jit fusion XLA's CPU backend contracts ``phase_resid + n *
    freq_resid`` into a fused multiply-add, one float32 ulp from eager JAX,
    which the port matches (ROADMAP §3 item 2)."""
    for name in ("k", "r", "dr"):
        np.testing.assert_array_equal(getattr(tn, name), getattr(jn, name))
    rows = [i for i in range(len(tn.k)) if i not in steered]
    for a, b in zip(tn.nco, jn.nco):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a[rows], b[rows])
    t, j = tn.nco, jn.nco
    for i in steered:
        dphase = (_cycles(t.phase[i], t.phase_resid[i])
                  - _cycles(j.phase[i], j.phase_resid[i]))
        assert abs(dphase - np.round(dphase)) <= 2e-5
        dfreq = (_cycles(t.freq[i], t.freq_resid[i])
                 - _cycles(j.freq[i], j.freq_resid[i]))
        assert abs(dfreq - np.round(dfreq)) <= 1e-9
    d, jd = tn.demod, jn.demod
    for name in ("snr_below", "pl_counter", "pll_lock", "lock_count",
                 "fft_samples", "delta_f"):
        if hasattr(jd, name):
            np.testing.assert_array_equal(getattr(d, name), getattr(jd, name))
    if hasattr(jd, "agc"):
        np.testing.assert_array_equal(d.agc.hangcount, jd.agc.hangcount)


def _bits(t):
    """A tensor's bit patterns (NaN equals NaN, -0 differs from +0)."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_trees_equal(a, b):
    """Bit for bit, leaf for leaf."""
    la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


def _bank_pair(mode, kind, warm=True):
    """A JAX bank and a port bank that took over its state after one
    warm-up block (the AGC's cold start, ROADMAP §3), and the blocks."""
    kw = dict(samprate=FS, L=LW, M=M, enable_pl=True)
    jbank = JB.ChannelBank(JB.make_bank_config(B, mode, **kw), FREQS)
    tbank = TB.ChannelBank(TB.make_bank_config(B, mode, **kw), FREQS,
                           device="cpu")
    blocks = _blocks(1 + 2 * K, kind)
    if warm:
        jbank.process_i16_pcm(blocks[0])
    tbank.state = state_from_jax(_jax_state(jbank), device="cpu")
    return jbank, tbank, blocks[1:]


# ---- the helpers ----

def test_write_state_in_place_and_order_free():
    """write_state copies into the static tensors themselves; a shared
    destination is written once; a source that is a view overlapping a
    destination is read before anything is written."""
    a = torch.arange(4.0)
    shared = torch.zeros(3)
    dst = [(a, shared), {"x": shared, "y": torch.ones(2)}]
    ptrs = [t.data_ptr() for t in graphs.tree_leaves(dst)]
    src = [(a[[1, 2, 3, 0]], torch.full((3,), 7.0)),
           {"x": torch.full((3,), 7.0), "y": dst[1]["y"]}]
    graphs.write_state(dst, src)
    assert [t.data_ptr() for t in graphs.tree_leaves(dst)] == ptrs
    assert torch.equal(a, torch.tensor([1.0, 2.0, 3.0, 0.0]))
    assert torch.equal(shared, torch.full((3,), 7.0))
    # v[:3] takes v[1:], a view of the same memory shifted by one
    v = torch.arange(4.0)
    w = v[:3]
    graphs.write_state([w, v[3:]], [v[1:], torch.zeros(1)])
    assert torch.equal(v, torch.tensor([1.0, 2.0, 3.0, 0.0]))
    with pytest.raises(ValueError, match="shape"):
        graphs.write_state([a], [torch.zeros(5)])
    with pytest.raises(ValueError, match="tensors"):
        graphs.write_state([a], [a, a])


def test_clone_and_static_copy_sharing():
    """clone_tree keeps one tensor that sits at two leaves one tensor;
    static_copy gives every leaf its own."""
    t = torch.zeros(2)
    tree = {"a": t, "b": (t, None, 3)}
    c = graphs.clone_tree(tree)
    assert c["a"] is c["b"][0] and c["a"] is not t and c["b"][1:] == (None, 3)
    s = graphs.static_copy(tree)
    assert s["a"] is not s["b"][0]


def test_scan_is_the_step_loop():
    state = torch.zeros(3)
    xs = torch.arange(12.0).reshape(4, 3)

    def step(s, x):
        s = s + x
        return s, s * 2.0

    final, ys = graphs.scan(step, state, xs)
    loop, outs = state, []
    for x in xs:
        loop, y = step(loop, x)
        outs.append(y)
    assert torch.equal(final, loop) and torch.equal(ys, torch.stack(outs))
    with pytest.raises(ValueError):
        graphs.scan(step, state, xs[:0])


def test_eager_step_writes_state_and_owns_outputs():
    """On the CPU a StepGraphs runs eagerly: the state's tensors are
    written in place, and an output that is a state tensor is returned as
    a copy, so the next block does not change it; nothing is captured."""
    g = graphs.StepGraphs("cpu")
    assert not g.capture
    state = (torch.zeros(2), torch.ones(2))

    def fn(s, x):
        return (s[0] + x, s[1]), (s[1], s[0] + x)

    ptr = state[0].data_ptr()
    out = g.run("k", fn, state, (torch.ones(2),))
    assert state[0].data_ptr() == ptr and torch.equal(state[0],
                                                      torch.ones(2))
    assert out[0] is not state[1] and torch.equal(out[0], state[1])
    state[1].fill_(5.0)
    assert torch.equal(out[0], torch.ones(2))
    assert g.graphs == {} and g.replays == 0


# ---- the wrappers against JAX ----

@pytest.mark.parametrize("mode,kind,pcm_out", [("FM", "fm", False),
                                               ("CAM", "am", True)])
def test_bank_scan_matches_jax_and_single_steps(mode, kind, pcm_out):
    """process_scan_i16 over K blocks: the JAX scan's audio and state, and
    bit for bit the same K blocks stepped one at a time on the port."""
    jbank, tbank, blocks = _bank_pair(mode, kind)
    twin = TB.ChannelBank(tbank.cfg, FREQS, device="cpu")
    twin.state = tbank.state
    xs = np.stack(blocks[:K])
    want = np.asarray(jbank.process_scan_i16(xs, pcm_out=pcm_out))
    got = tbank.process_scan_i16(xs, pcm_out=pcm_out)
    step = twin.process_i16_pcm if pcm_out else twin.process_i16
    loop = torch.stack([step(x)[0] for x in blocks[:K]])
    assert torch.equal(got, loop)
    assert_trees_equal(tbank.state, twin.state)
    assert got.shape == want.shape == (K, B, 960)
    assert got.dtype == (torch.int16 if pcm_out else torch.float32)
    for t, j in zip(got.numpy(), want):
        if pcm_out:
            assert_pcm_close(t, j)
        else:
            assert_fm_audio_close(t, j)
    assert_discrete_equal(state_to_numpy(tbank.state), _jax_state(jbank))
    # the scan's state carries on into the next single block
    ja, _ = jbank.process_i16_pcm(blocks[K])
    ta, _ = tbank.process_i16_pcm(blocks[K])
    assert_pcm_close(ta.numpy(), np.asarray(ja), 8 if pcm_out else 1)


def test_active_across_retune_matches_jax():
    """process_active before and after a retune moves a noise channel
    onto an FM carrier: the active sets follow exactly, the rows within
    1 LSB."""
    jbank, tbank, blocks = _bank_pair("FM", "fm")
    sets = []
    for b, x in enumerate(blocks[:6]):
        if b == 2:
            for bank in (jbank, tbank):
                bank.tune(0, FREQS[3] + 37.0)       # onto channel 3's carrier
            assert_discrete_equal(state_to_numpy(tbank.state),
                                  _jax_state(jbank))
        jp, ji, _ = jbank.process_active(x, max_active=5)
        tp, ti, _ = tbank.process_active(x, max_active=5)
        jp, ji, tp, ti = np.asarray(jp), np.asarray(ji), tp.numpy(), ti.numpy()
        np.testing.assert_array_equal(np.sort(ti), np.sort(ji))
        for row, ch in enumerate(ti):
            if ch >= 0:
                assert_pcm_close(tp[row], jp[list(ji).index(ch)], 1)
        sets.append({int(c) for c in ti if c >= 0})
        assert_discrete_equal(state_to_numpy(tbank.state), _jax_state(jbank))
    # block 0 is the noise channels' squelch flush block (fm.c:115-116)
    assert all(set(FM_SIGNAL) <= s for s in sets[1:])
    assert 0 not in sets[1] and all(0 in s for s in sets[2:])


def test_multibank_init_channel_and_fm_filter_swap_match_jax():
    """FM, USB and CAM groups off one master: a row re-commissioned
    (init_channel), then the FM group's filter narrowed, whose audio gain
    follows fm.c:85-86.  The JAX MultiBank's jitted step keeps the gain it
    was traced with (ROADMAP §3), so it is traced again (a new function
    object: jit's cache is keyed on the function) to hold the port to what
    its set_filter means."""
    modes = ("FM", "USB", "CAM")
    fr = list(np.linspace(-0.45 * FS, 0.45 * FS, 9, endpoint=False))
    groups = [(m, fr[3 * g:3 * g + 3]) for g, m in enumerate(modes)]
    jmb = JB.MultiBank(groups, samprate=FS, L=LW, M=M)
    tmb = TB.MultiBank(groups, samprate=FS, L=LW, M=M, device="cpu")
    rng = np.random.default_rng(11)
    n = 7
    blocks = []
    for b in range(n):
        t = (b * LW + np.arange(LW)) / FS
        sig = 0.003 * (rng.standard_normal(LW) + 1j * rng.standard_normal(LW))
        sig = sig + 0.2 * np.exp(1j * (2 * np.pi * fr[1] * t
                                       + 3.0 * np.sin(2 * np.pi * 1000 * t)))
        sig = sig + 0.1 * np.exp(2j * np.pi * (fr[4] + 1000.0) * t)
        sig = sig + 0.1 * (1 + 0.5 * np.cos(2 * np.pi * 1000 * t)) * np.exp(
            2j * np.pi * (fr[7] + 17 * BIN) * t)
        blocks.append(_i16(sig))
    scale = np.float32(1.0 / 32767.0)
    jmb.process(blocks[0].astype(np.float32) * scale)        # warm-up
    states = [state_from_jax(_np(tree_r2c(s, tm)), device="cpu")
              for s, tm in zip(jmb.states, jmb._templates)]
    tmb.states = [s._replace(overlap=states[0].overlap) for s in states]
    for b in range(1, n):
        if b == 2:
            for mb in (jmb, tmb):
                mb.init_channel(2, 1, fr[7])
        if b == 4:
            for mb in (jmb, tmb):
                mb.set_filter(0, -6000.0, 6000.0)
            assert tmb.cfgs[0].demod_cfg.gain == jmb.cfgs[0].demod_cfg.gain
            jmb._step = jax.jit(lambda s, x, f=jmb._step.__wrapped__:
                                f(s, x))
        jout = jmb.process(blocks[b].astype(np.float32) * scale)
        tout = tmb.process_i16_pcm(blocks[b])
        for g, mode in enumerate(modes):
            ts = state_to_numpy(tmb.states[g])
            js = _np(tree_r2c(jmb.states[g], jmb._templates[g]))
            assert_discrete_equal(ts, js)
            np.testing.assert_array_equal(ts.resp, js.resp)
            (tp, td), (ja, jd) = tout[g], jout[g]
            jp = np.clip(np.asarray(ja) * 32767.0, -32768,
                         32767).astype(np.int16)
            assert tp.dtype == torch.int16
            assert_pcm_close(tp.numpy(), jp, 1 if mode == "FM" else 8)
    assert all(s.overlap is tmb.states[0].overlap for s in tmb.states)
    cam = state_to_numpy(tmb.states[2]).demod
    assert cam.fft_samples[1] < cam.fft_samples[0]       # row 1 respawned


def _rx_pair(mode):
    jrx = JR.Receiver(JR.make_receiver_config(mode, samprate=RX_FS))
    trx = TR.Receiver(TR.make_receiver_config(mode, samprate=RX_FS),
                      device="cpu")
    trx.state = state_from_jax(_np(tree_r2c(jrx.state, jrx._template)),
                               device="cpu")
    for rx in (jrx, trx):
        rx.set_freq(RX_TUNE)
    return jrx, trx


def _rx_blocks(n, seed=9, offs=(1000.0,)):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        t = (b * RX_L + np.arange(RX_L)) / RX_FS
        x = 0.003 * (rng.standard_normal(RX_L) + 1j * rng.standard_normal(RX_L))
        for off in offs:
            x = x + 0.1 * np.exp(2j * np.pi * (RX_TUNE + off) * t)
        out.append(x.astype(np.complex64))
    return out


def _rx_pcm(a):
    return np.clip(np.asarray(a) * 32767.0, -32768, 32767).astype(np.int64)


def _rx_state_equal(trx, jrx):
    """The receiver's exact leaves: LO2 and Doppler NCO words, the AGC
    hang count."""
    ts = state_to_numpy(trx.state)
    js = _np(tree_r2c(jrx.state, jrx._template))
    for osc in ("lo2", "doppler"):
        for a, b in zip(getattr(ts, osc), getattr(js, osc)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.demod.agc.hangcount,
                                  js.demod.agc.hangcount)


def test_receiver_offline_matches_jax():
    """process_offline over K int16 blocks (one step of K on the card)
    against JAX's scan, twice in a row so the second scan starts from the
    first's state; the port's audio equals its own block loop."""
    jrx, trx = _rx_pair("USB")
    twin = TR.Receiver(trx.cfg, device="cpu")
    twin.state = trx.state
    x = np.stack([_i16(b) for b in _rx_blocks(2 * K)])
    for first, part in ((1, x[:K]), (0, x[K:])):
        want = jrx.process_offline(part)
        got = trx.process_offline(part)
        assert got.shape == want.shape == (K, 960)
        loop = torch.stack([twin.process(TB.iq_from_i16(torch.as_tensor(p)))[0]
                            for p in part])
        assert torch.equal(got, loop)
        # the AGC's cold start in block 0 (ROADMAP §3): from block 1 on
        for b in range(first, K):
            assert_pcm_close(_rx_pcm(got[b].numpy()), _rx_pcm(want[b]))
        _rx_state_equal(trx, jrx)


def test_live_edits_between_blocks_match_jax():
    """A bank retuned and Doppler-steered between blocks, and a receiver
    whose second LO and Doppler move between blocks: each edit writes into
    the static state that the next block reads, as the JAX state edit
    feeds its next jitted block."""
    jbank, tbank, blocks = _bank_pair("FM", "fm", warm=False)
    edits = {1: lambda bk: bk.tune(3, FREQS[3] + 2000.0),
             2: lambda bk: bk.set_doppler(6, 80.0, 0.0),
             3: lambda bk: bk.tune(1, FREQS[1])}
    for b, x in enumerate(blocks[:5]):
        if b in edits:
            edits[b](jbank)
            edits[b](tbank)
            assert tbank.freqs == jbank.freqs
        ja, jd = jbank.process_i16_pcm(x)
        ta, td = tbank.process_i16_pcm(x)
        assert_pcm_close(ta.numpy(), np.asarray(ja), 1)
        np.testing.assert_array_equal(td["squelch_open"].numpy(),
                                      np.asarray(jd["squelch_open"]))
        assert_discrete_equal(state_to_numpy(tbank.state), _jax_state(jbank),
                              steered=(6,) if b >= 2 else ())
    jrx, trx = _rx_pair("USB")
    rx_edits = {1: lambda rx: rx.set_second_lo(-RX_TUNE - 500.0),
                2: lambda rx: rx.set_doppler(-500.0, 0.0),
                3: lambda rx: rx.set_freq(RX_TUNE + 250.0)}
    for b, x in enumerate(_rx_blocks(5, offs=(1000.0, 1500.0))):
        if b in rx_edits:
            assert rx_edits[b](jrx) == rx_edits[b](trx)
        ja, _ = jrx.process(x)
        ta, _ = trx.process(x)
        if b >= 1:              # from block 1 on, as above
            assert_pcm_close(_rx_pcm(ta.numpy()), _rx_pcm(ja))
        _rx_state_equal(trx, jrx)


def test_fm_set_filter_gain_follows_fm_c():
    """set_filter on an FM bank and an FM receiver: the audio gain follows
    the new edges (fm.c:85-86), as the port's eager step always did; the
    JAX jitted steps keep the gain they were traced with (ROADMAP §3), so
    they are traced again with the new config to compare."""
    jbank, tbank, blocks = _bank_pair("FM", "fm", warm=False)
    for x in blocks[:2]:
        jbank.process_i16_pcm(x)
        tbank.process_i16_pcm(x)
    for bank in (jbank, tbank):
        bank.set_filter(-6000.0, 6000.0)
    assert tbank.cfg.demod_cfg.gain == jbank.cfg.demod_cfg.gain
    jbank._step_i16 = jax.jit(JB.bank_step_packed_i16(jbank.cfg,
                                                      jbank._template))
    peaks = []
    for x in blocks[2:5]:
        ja, _ = jbank.process_i16(x)
        ta, _ = tbank.process_i16(x)
        assert_fm_audio_close(ta.numpy(), np.asarray(ja))
        peaks.append(float(ta[list(FM_SIGNAL)].abs().max()))
        assert_discrete_equal(state_to_numpy(tbank.state), _jax_state(jbank))
    jrx, trx = _rx_pair("FM")
    x = _rx_blocks(4, offs=())
    rng = np.random.default_rng(2)
    t = (np.arange(4 * RX_L) / RX_FS).reshape(4, RX_L)
    fm = (0.3 * np.exp(1j * (2 * np.pi * RX_TUNE * t
                             + 3.0 * np.sin(2 * np.pi * 1000 * t)))
          + 0.003 * rng.standard_normal((4, RX_L))).astype(np.complex64)
    for b in range(4):
        if b == 2:
            for rx in (jrx, trx):
                rx.set_filter(low=-6000.0, high=6000.0)
            jrx._step = jax.jit(JR.receiver_step_packed(jrx.cfg,
                                                        jrx._template))
        ja, _ = jrx.process(fm[b] + x[b])
        ta, _ = trx.process(fm[b] + x[b])
        assert_fm_audio_close(ta.numpy(), np.asarray(ja))
    assert min(peaks) > 0.0


def test_outputs_and_state_copies_survive_later_blocks():
    """What a call returned (audio, diagnostics, a scan, the active rows,
    a MultiBank's groups, the receiver's audio) and a copy of ``state``
    read between blocks are unchanged after two more blocks have stepped;
    two reads between blocks give one copy."""
    _, tbank, blocks = _bank_pair("FM", "fm", warm=False)
    held = [tbank.process_i16_pcm(blocks[0]), tbank.process_i16(blocks[1]),
            tbank.process_active(blocks[2], max_active=4),
            tbank.process_scan_i16(np.stack(blocks[3:5]))]
    snap = tbank.state
    assert tbank.state is snap
    want = graphs.clone_tree(held), graphs.clone_tree(snap)
    for x in blocks[5:7]:
        tbank.process_i16_pcm(x)
    assert tbank.state is not snap
    assert_trees_equal((held, snap), want)
    mb = TB.MultiBank([("FM", FREQS[:2]), ("USB", FREQS[2:4])], samprate=FS,
                      L=LW, M=M, device="cpu")
    out = mb.process_i16(blocks[0])
    keep = graphs.clone_tree(out)
    mb.process_i16(blocks[1])
    mb.process_i16(blocks[2])
    assert_trees_equal(out, keep)
    trx = TR.Receiver(TR.make_receiver_config("USB", samprate=RX_FS),
                      device="cpu")
    rx_blocks = _rx_blocks(3)
    a0 = trx.process(rx_blocks[0])
    keep = graphs.clone_tree(a0)
    trx.process(rx_blocks[1])
    trx.process_offline(np.stack([_i16(rx_blocks[2])] * 2))
    assert_trees_equal(a0, keep)
