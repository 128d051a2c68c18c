"""Parity of the port's FM+PL channel bank against the JAX package on the
CPU, both started from one state through ``interop.state_from_jax``.

Geometry: 8 channels at fs = 1.536 Msps, L = 30720, M = 34817, so N = 65536,
decimate 32, and the serving geometry's per-channel shape (N_dec 2048,
L_dec 960, M_dec 1089).  Channels 1, 3 and 6 carry FM with 1 kHz audio and a
PL tone; the others carry noise only.  Inputs are int16 blocks made with
numpy from a fixed seed.

Tolerances, with their reasons:

- PCM: within 1 LSB.  The port gathers each channel's bins directly where
  the JAX package takes its aligned chunk-row path, and the FFTs differ, so
  the audio differs at the float32 rounding level (~1e-7); the int16
  conversion truncates, so a sample next to a step may land one LSB apart.
- squelch, PL counters, active-channel sets, k/r/dr and the NCO words:
  exact.  The FM channels keep a wide margin over the blanking threshold.
- float state: the overlaps and rings within 1e-5 of their own scale, the
  NCO residuals exact (same float32 operations on the same inputs).
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

FS, LW, M, B = 1.536e6, 30720, 34817, 8
SIGNAL = (1, 3, 6)
FREQS = list(np.linspace(-0.45 * FS, 0.45 * FS, B, endpoint=False))
PCM_BLOCKS, ACTIVE_BLOCKS = 22, 2


def _i16_blocks(n_blocks, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        t = (b * LW + np.arange(LW)) / FS
        sig = 0.003 * (rng.standard_normal(LW) + 1j * rng.standard_normal(LW))
        for j, ch in enumerate(SIGNAL):
            ph = (3.0 * np.sin(2 * np.pi * 1000 * t + j)
                  + (500 / 100.0) * np.sin(2 * np.pi * 100.0 * t))
            sig = sig + 0.2 * np.exp(1j * (2 * np.pi * (FREQS[ch] + 37.0 * j)
                                           * t + ph))
        x = np.empty((LW, 2), np.int16)
        x[:, 0] = np.clip(sig.real * 32767, -32768, 32767)
        x[:, 1] = np.clip(sig.imag * 32767, -32768, 32767)
        out.append(x)
    return out


def _jax_state(jbank):
    return jax.tree_util.tree_map(np.asarray,
                                  tree_r2c(jbank.state, jbank._template))


def _assert_states_match(js, ts):
    """js: JAX-package state (numpy leaves), ts: the port's state."""
    tn = state_to_numpy(ts)
    assert [type(x).__name__ for x in (tn, tn.nco, tn.demod)] == \
        ["BankState", "OscState", "FMState"]
    for name in ("k", "r", "dr"):
        np.testing.assert_array_equal(getattr(tn, name), getattr(js, name))
    for a, b in zip(tn.nco, js.nco):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("snr_below", "pl_counter"):
        np.testing.assert_array_equal(getattr(tn.demod, name),
                                      getattr(js.demod, name))
    for a, b in ((tn.overlap, js.overlap), (tn.demod.pl_ring, js.demod.pl_ring),
                 (tn.demod.audio_overlap, js.demod.audio_overlap),
                 (tn.demod.disc_state, js.demod.disc_state)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-5 * max(np.abs(b).max(), 1))


@pytest.fixture(scope="module")
def runs():
    jcfg = JB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M, enable_pl=True)
    tcfg = TB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M, enable_pl=True)
    np.testing.assert_array_equal(tcfg.response, jcfg.response)
    np.testing.assert_array_equal(tcfg.base_idx, jcfg.base_idx)
    jbank = JB.ChannelBank(jcfg, FREQS)
    tbank = TB.ChannelBank(tcfg, FREQS, device="cpu")
    # the port's own bank_init agrees with the JAX package's exactly
    _assert_states_match(_jax_state(jbank), tbank.state)
    tbank.state = state_from_jax(_jax_state(jbank), device="cpu")
    blocks = _i16_blocks(PCM_BLOCKS + ACTIVE_BLOCKS)
    pcm = []
    for x in blocks[:PCM_BLOCKS]:
        ja, jd = jbank.process_i16_pcm(x)
        ta, td = tbank.process_i16_pcm(x)
        pcm.append((np.asarray(ja), ta.numpy(),
                    {k: np.asarray(v) for k, v in jd.items()},
                    {k: v.numpy() for k, v in td.items()}))
    active = []
    for x in blocks[PCM_BLOCKS:]:
        jp, ji, _ = jbank.process_active(x, max_active=4)
        tp, ti, _ = tbank.process_active(x, max_active=4)
        active.append((np.asarray(jp), np.asarray(ji), tp.numpy(), ti.numpy()))
    return pcm, active, _jax_state(jbank), tbank.state


def test_pcm_matches(runs):
    pcm, _, _, _ = runs
    for ja, ta, _, _ in pcm:
        assert ta.dtype == ja.dtype == np.int16 and ta.shape == ja.shape
        assert np.abs(ta.astype(np.int32) - ja.astype(np.int32)).max() <= 1
    # signal channels carry the 1 kHz audio; noise-only channels are silent
    audio = np.concatenate([p[1] for p in pcm[10:]], axis=-1)
    for ch in range(B):
        if ch in SIGNAL:
            spec = np.abs(np.fft.rfft(audio[ch].astype(np.float64)))
            assert abs(np.argmax(spec) * 48000 / audio.shape[-1] - 1000) < 5
        else:
            assert not audio[ch].any()


def test_squelch_and_pl_match(runs):
    pcm, _, _, _ = runs
    for _, _, jd, td in pcm:
        np.testing.assert_array_equal(td["squelch_open"], jd["squelch_open"])
        np.testing.assert_array_equal(td["plfreq"], jd["plfreq"])
    last = pcm[-1][3]
    assert [bool(last["squelch_open"][c]) for c in range(B)] == \
        [c in SIGNAL for c in range(B)]
    for ch in SIGNAL:
        assert abs(last["plfreq"][ch] - 100.0) < 1.0


def test_active_sets_match(runs):
    """top-k tie order may differ between jax.lax.top_k and torch.topk, so
    the sets are compared, and the PCM rows matched by channel index."""
    _, active, _, _ = runs
    for jp, ji, tp, ti in active:
        assert set(ji[ji >= 0]) == set(ti[ti >= 0]) == set(SIGNAL)
        for ch in SIGNAL:
            a = tp[list(ti).index(ch)].astype(np.int32)
            b = jp[list(ji).index(ch)].astype(np.int32)
            assert np.abs(a - b).max() <= 1


def test_state_matches_after_run(runs):
    _, _, js, ts = runs
    _assert_states_match(js, ts)


def _cycles(word, resid):
    """A fixed-point word plus its float residual, in cycles (float64)."""
    return np.asarray(word, np.float64) / 2.0**32 + np.asarray(resid,
                                                                np.float64)


def test_doppler_swept_channel_recenters_exactly():
    """A swept channel hops k through bank_recenter; k, r and dr must
    follow the JAX package exactly, block by block.

    The NCO of a swept channel is compared as phase and frequency in
    cycles, not word by word: inside a jit fusion XLA's CPU backend
    contracts ``freq_resid + n * rate`` into one fused multiply-add, which
    moves the float32 sum by one ulp against eager JAX (which the port
    matches bit for bit, see test_torch_ops).  At these sweep rates that
    ulp is 2^-35 cycles/sample, and each block may add one.  Tolerances
    for 20 blocks: 1e-9 cycles/sample of frequency (> 20 such ulps) and
    2e-5 cycles of phase (20 ulps over 20 x 960 samples)."""
    jcfg = JB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M)
    tcfg = TB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M).to("cpu")
    js = JB.bank_init(jcfg, FREQS)
    js = JB.bank_set_doppler(jcfg, js, 2, FREQS[2], doppler_hz=-31.0,
                             rate_hz_s=4000.0)
    js = JB.bank_set_doppler(jcfg, js, 5, FREQS[5], doppler_hz=12.0,
                             rate_hz_s=-2500.0)
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    jstep = jax.jit(lambda s, x: JB.bank_step(jcfg, s, x))
    rng = np.random.default_rng(9)
    k0 = np.asarray(js.k).copy()
    for _ in range(20):
        x = (0.01 * (rng.standard_normal(LW) + 1j * rng.standard_normal(LW))
             ).astype(np.complex64)
        js, _, _ = jstep(js, x)
        ts, _, _ = TB.bank_step(tcfg, ts, torch.as_tensor(x))
        tn, jn = state_to_numpy(ts), jax.tree_util.tree_map(np.asarray, js)
        for name in ("k", "r", "dr"):
            np.testing.assert_array_equal(getattr(tn, name), getattr(jn, name))
        dphase = (_cycles(tn.nco.phase, tn.nco.phase_resid)
                  - _cycles(jn.nco.phase, jn.nco.phase_resid))
        assert np.abs(dphase - np.round(dphase)).max() <= 2e-5
        dfreq = (_cycles(tn.nco.freq, tn.nco.freq_resid)
                 - _cycles(jn.nco.freq, jn.nco.freq_resid))
        assert np.abs(dfreq - np.round(dfreq)).max() <= 1e-9
        np.testing.assert_array_equal(tn.nco.rate, jn.nco.rate)
    hops = np.asarray(js.k).astype(np.int64) - k0
    assert hops[2] != 0 and hops[5] != 0
    assert not np.delete(hops, [2, 5]).any()


def test_scan_and_complex_ingest_match_per_block():
    """process_scan_i16 is the per-block loop; process() on the same I/Q
    as complex64 gives process_i16's audio."""
    cfg = TB.make_bank_config(4, "FM", samprate=FS, L=LW, M=M, enable_pl=True)
    freqs = FREQS[:4]
    blocks = np.stack(_i16_blocks(3, seed=2))
    a, b, c, d = (TB.ChannelBank(cfg, freqs, device="cpu") for _ in range(4))
    scan = a.process_scan_i16(blocks, pcm_out=True)
    loop = torch.stack([b.process_i16_pcm(x)[0] for x in blocks])
    assert torch.equal(scan, loop)
    scale = np.float32(1.0 / 32767.0)        # the scaling bank_step_i16 applies
    for x in blocks:
        iq = x[:, 0].astype(np.float32) * scale \
            + 1j * (x[:, 1].astype(np.float32) * scale)
        audio, _ = c.process(iq.astype(np.complex64))
        ref, _ = d.process_i16(x)
        assert torch.equal(audio, ref)


def test_non_fm_modes_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TB.make_bank_config(4, "USB", samprate=FS, L=LW, M=M)
