"""The port's two ``lax.cond`` gates against the JAX package on the CPU:
``utils.graphs.cond`` itself, the PL measurement of ``demod_fm`` and the
PLL acquisition of ``demod_linear``, run only on the blocks where some
channel is due.

Every input comes from numpy with a fixed seed.  Which blocks are due is
read off the JAX side's own state after each block: the FM demodulator
zeroes ``pl_counter`` exactly on the channels whose ``do_fft`` held (it
grows by L_dec/32 = 30 otherwise), and the PLL zeroes ``fft_samples``
exactly there (it grows by 960/32 = 30 otherwise).  The port's
``_pl_measure`` and ``_acquire`` are counted by monkeypatch, block by
block; the counts are exact integers.

Tolerances, with their reasons:

- FM (tests/test_torch_fm.py's): audio max |diff| <= 1e-5 and RMS diff
  <= 1e-6; snr rtol 1e-4; squelch flags, ``plfreq`` and the PL counters
  exact; the PL ring within 1e-6 of its own scale and the other float
  state as there.  A channel's measurement is a bin index times a
  constant, and the peak bins are clear.
- PLL (tests/test_torch_linear.py's): the lock state, ``lock_count``,
  ``fft_samples`` and ``delta_f`` exact; audio within the PARITY.md #9
  bounds on int16 PCM; the float state within 1e-4 of each leaf's scale.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ka9q_sdr_tpu.models import bank as JB
from ka9q_sdr_tpu.models import demod_fm as JD
from ka9q_sdr_tpu.models import demod_linear as JL
from ka9q_sdr_tpu_torch.interop import state_to_numpy
from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.models import demod_fm as TD
from ka9q_sdr_tpu_torch.models import demod_linear as TL
from ka9q_sdr_tpu_torch.utils.graphs import cond

from test_torch_linear import _assert_float_state, assert_parity9

torch.set_num_threads(1)

FS, N = 48000.0, 960
BIN = FS / JL.PLL_FFT_SIZE


class _Row(NamedTuple):
    """The part of a BankState that ``bank_reset_demod_row`` edits."""
    demod: object


class _Counter:
    """Wraps a module function and counts its calls."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        fn = getattr(module, name)

        def counted(*a):
            self.n += 1
            return fn(*a)

        monkeypatch.setattr(module, name, counted)


# ---- (a) cond itself -------------------------------------------------------

class _Pair(NamedTuple):
    a: torch.Tensor
    b: dict


@pytest.mark.parametrize("take", [True, False])
def test_cond_cpu_takes_one_branch(take):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((3, 5)).astype(np.float32))
    ran = []

    def true_fn(v):
        ran.append("true")
        return _Pair(v * 2.0, {"s": v.sum(-1), "n": [v[0]]})

    def false_fn(v):
        ran.append("false")
        return _Pair(v, {"s": torch.zeros(3), "n": [v[1]]})

    out = cond(torch.tensor(take), true_fn, false_fn, x)
    assert ran == ["true" if take else "false"]
    want = true_fn(x) if take else false_fn(x)
    assert isinstance(out, _Pair)
    torch.testing.assert_close(out.a, want.a, rtol=0, atol=0)
    torch.testing.assert_close(out.b["s"], want.b["s"], rtol=0, atol=0)
    torch.testing.assert_close(out.b["n"][0], want.b["n"][0], rtol=0, atol=0)


@pytest.mark.parametrize("take", [True, False])
def test_cond_matches_lax_cond(take):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(16).astype(np.float32)
    pred = np.bool_(take)
    jout = jax.lax.cond(jnp.asarray(pred), lambda v: (jnp.cumsum(v), v.max()),
                        lambda v: (v * 0.5, v.min()), jnp.asarray(x))
    tout = cond(torch.as_tensor(pred), lambda v: (torch.cumsum(v, 0), v.max()),
                lambda v: (v * 0.5, v.min()), torch.as_tensor(x))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("pred", [torch.tensor([True]), torch.tensor(1),
                                  torch.ones(2, dtype=torch.bool)])
def test_cond_needs_a_0d_bool(pred):
    with pytest.raises(ValueError, match="0-d bool"):
        cond(pred, lambda: 1, lambda: 0)


# ---- (b), (d) the PL gate --------------------------------------------------

FM_BLOCKS, FM_RESET = 48, (10, 1)     # block, channel of the row reset
PL_TONES = (100.0, 151.4, 123.0, None)


def _fm_blocks():
    rng = np.random.default_rng(23)
    t = np.arange(FM_BLOCKS * N) / FS
    rows = []
    for j, pl in enumerate(PL_TONES):
        ph = 2.5 * np.sin(2 * np.pi * 1000 * t + j)
        if pl is not None:
            ph = ph + (600 / pl) * np.sin(2 * np.pi * pl * t)
        rows.append(0.3 * np.exp(1j * (2 * np.pi * 150 * t + ph)))
    x = np.stack(rows) + 0.01 * (rng.standard_normal((4, t.size))
                                 + 1j * rng.standard_normal((4, t.size)))
    return x.astype(np.complex64).reshape(4, FM_BLOCKS, N).transpose(1, 0, 2)


@pytest.fixture(scope="module")
def fm_run():
    """Both demodulators over the same blocks; at FM_RESET one row is
    reset by each package's ``bank_reset_demod_row`` (what
    ``MultiBank.init_channel`` does to it), so its PL counter runs out of
    step with the others'.  Returns per block (JAX any(do_fft), port
    _pl_measure calls, JAX out, port out) and the final states."""
    mp = pytest.MonkeyPatch()
    try:
        calls = _Counter(mp, TD, "_pl_measure")
        jcfg = JD.FMConfig.make(FS, -8000, 8000, N, 1089, enable_pl=True)
        tcfg = TD.FMConfig.make(FS, -8000, 8000, N, 1089,
                                enable_pl=True).to("cpu")
        jstep = jax.jit(lambda s, x: JD.fm_demod(jcfg, s, x))
        js, ts = JD.fm_init(jcfg, (4,)), TD.fm_init(tcfg, (4,), device="cpu")
        jfresh = JD.fm_init(jcfg, (4,))
        tfresh = TD.fm_init(tcfg, (4,), device="cpu")
        out = []
        for b, x in enumerate(_fm_blocks()):
            if b == FM_RESET[0]:
                js = JB.bank_reset_demod_row(_Row(js), jfresh, FM_RESET[1],
                                             4).demod
                ts = TB.bank_reset_demod_row(_Row(ts), tfresh, FM_RESET[1],
                                             4).demod
            before = calls.n
            js, ja, jd = jstep(js, jnp.asarray(x))
            ts, ta, td = TD.fm_demod(tcfg, ts, torch.as_tensor(x))
            due = np.asarray(js.pl_counter) == 0
            out.append((due, calls.n - before, np.asarray(ja), ta.numpy(),
                        {k: np.asarray(v) for k, v in jd.items()},
                        {k: v.numpy() for k, v in td.items()}))
    finally:
        mp.undo()
    return out, js, ts


def test_pl_gate_matches_jax(fm_run):
    out, _, _ = fm_run
    for due, _, ja, ta, jd, td in out:
        d = ta.astype(np.float64) - ja
        assert np.abs(d).max() <= 1e-5 and np.sqrt(np.mean(d ** 2)) <= 1e-6
        np.testing.assert_array_equal(td["squelch_open"], jd["squelch_open"])
        np.testing.assert_allclose(td["snr"], jd["snr"], rtol=1e-4)
        np.testing.assert_array_equal(td["plfreq"], jd["plfreq"])
    last = out[-1][5]["plfreq"]
    for got, want in zip(last, PL_TONES):
        assert np.isnan(got) if want is None else abs(got - want) < 1.0


def test_pl_gate_state_matches_jax(fm_run):
    _, js, ts = fm_run
    np.testing.assert_array_equal(ts.pl_counter.numpy(),
                                  np.asarray(js.pl_counter))
    np.testing.assert_array_equal(ts.plfreq.numpy(), np.asarray(js.plfreq))
    np.testing.assert_array_equal(ts.snr_below.numpy(),
                                  np.asarray(js.snr_below))
    ring = np.asarray(js.pl_ring)
    np.testing.assert_allclose(ts.pl_ring.numpy(), ring,
                               atol=1e-6 * np.abs(ring).max())
    np.testing.assert_allclose(ts.audio_overlap.numpy(),
                               np.asarray(js.audio_overlap), atol=1e-5)
    np.testing.assert_allclose(ts.disc_state.numpy(),
                               np.asarray(js.disc_state), atol=1e-6)
    np.testing.assert_allclose(ts.lastaudio.numpy(), np.asarray(js.lastaudio),
                               atol=1e-5)


def test_pl_measure_runs_on_due_blocks_only(fm_run):
    out, _, _ = fm_run
    due = np.array([o[0] for o in out])           # (blocks, channels)
    calls = [o[1] for o in out]
    assert calls == [int(d.any()) for d in due]
    fired = [b for b, d in enumerate(due) if d.any()]
    # two firings of the bank, and the reset row's own out of step
    assert fired == [17, 27, 35, 45]
    assert due[27].tolist() == [False, True, False, False]
    assert sum(calls) == 4


# ---- (c), (d) the PLL acquisition gate -------------------------------------

PLL_BLOCKS, DROPOUT = 120, (80, 120)      # channel 1's carrier gone there
PLL_OFFS = (37 * BIN, -56 * BIN, 17 * BIN, 61 * BIN)


def _pll_blocks():
    rng = np.random.default_rng(5)
    t = np.arange(PLL_BLOCKS * N) / FS
    x = 0.01 * (rng.standard_normal((4, t.size))
                + 1j * rng.standard_normal((4, t.size)))
    mod = 1.0 + 0.5 * np.cos(2 * np.pi * 1000 * t)
    gone = (t >= DROPOUT[0] * N / FS) & (t < DROPOUT[1] * N / FS)
    for c, f in enumerate(PLL_OFFS):
        carrier = 0.1 * mod * np.exp(1j * (2 * np.pi * f * t + 0.7 * c))
        if c == 1:
            carrier[gone] = 0.0
        x[c] += carrier
    return x.astype(np.complex64).reshape(4, PLL_BLOCKS, N).transpose(1, 0, 2)


def test_pll_gate_matches_jax(monkeypatch):
    """Four AM carriers acquire and lock; while all four hold, no search
    runs; channel 1's carrier drops out, it unlocks and the search runs
    again for it alone."""
    calls = _Counter(monkeypatch, TL, "_acquire")
    kw = dict(recovery_rate_db_s=50.0, hangtime_s=0.0, pll=True, channels=1,
              lock_time=0.2)
    jcfg, tcfg = JL.LinearConfig.make(FS, N, **kw), TL.LinearConfig.make(
        FS, N, **kw)
    step = jax.jit(lambda s, x: JL.linear_demod(jcfg, s, x))
    js = JL.linear_init(jcfg, (4,))
    ts = TL.linear_init(tcfg, (4,), device="cpu")
    due, ran, locked = [], [], []
    for x in _pll_blocks():
        before = calls.n
        js, ja, _ = step(js, jnp.asarray(x))
        ts, ta, _ = TL.linear_demod(tcfg, ts, torch.as_tensor(x))
        assert_parity9(ta.numpy(), ja)
        jn, tn = jax.tree_util.tree_map(np.asarray, js), state_to_numpy(ts)
        for name in ("pll_lock", "lock_count", "fft_samples", "delta_f"):
            np.testing.assert_array_equal(getattr(tn, name),
                                          getattr(jn, name))
        due.append(jn.fft_samples == 0)
        ran.append(calls.n - before)
        locked.append(jn.pll_lock.copy())
    _assert_float_state(tn, jn)
    np.testing.assert_allclose(tn.delta_f, PLL_OFFS, atol=BIN)
    assert ran == [int(d.any()) for d in due]
    fired = [b for b, d in enumerate(due) if d.any()]
    assert fired[0] == 34 and len(fired) >= 2
    # a stretch where every carrier is locked and nothing is searched
    all_locked = [b for b, lk in enumerate(locked) if lk.all()]
    assert len(all_locked) >= 5
    assert not any(ran[b] for b in all_locked)
    # the dropout unlocks channel 1, and the next search is for it alone
    after = [b for b in fired if b >= DROPOUT[0]]
    assert after and not locked[after[0]][1]
    assert due[after[0]].tolist() == [False, True, False, False]


# ---- (d) on the banks' path: MultiBank.init_channel ------------------------

def test_multibank_gates_fire_with_jax(monkeypatch):
    """The FM and CAM groups of one MultiBank in both packages, the same
    blocks, an ``init_channel`` on an FM row mid-run: the port measures PL
    and searches for carriers on exactly the blocks where the JAX
    MultiBank's ``any(do_fft)`` holds."""
    pl = _Counter(monkeypatch, TD, "_pl_measure")
    acq = _Counter(monkeypatch, TL, "_acquire")
    fs, lw, m = 1.536e6, 30720, 34817
    fr = list(np.linspace(-0.45 * fs, 0.45 * fs, 6, endpoint=False))
    groups = [("FM", fr[:3]), ("CAM", fr[3:])]
    jmb = JB.MultiBank(groups, samprate=fs, L=lw, M=m, enable_pl=True)
    tmb = TB.MultiBank(groups, samprate=fs, L=lw, M=m, device="cpu",
                       enable_pl=True)
    rng = np.random.default_rng(9)
    pl_fired, acq_fired = [], []
    for b in range(40):
        if b == 9:
            jmb.init_channel(0, 1, fr[1])
            tmb.init_channel(0, 1, fr[1])
        t = (b * lw + np.arange(lw)) / fs
        sig = 0.003 * (rng.standard_normal(lw) + 1j * rng.standard_normal(lw))
        sig = sig + 0.1 * np.exp(1j * (2 * np.pi * fr[0] * t
                                       + 3.0 * np.sin(2 * np.pi * 1000 * t)))
        sig = sig + 0.1 * np.exp(2j * np.pi * (fr[4] + 17 * BIN) * t)
        x = np.empty((lw, 2), np.int16)
        x[:, 0] = np.clip(sig.real * 32767, -32768, 32767)
        x[:, 1] = np.clip(sig.imag * 32767, -32768, 32767)
        n_pl, n_acq = pl.n, acq.n
        jmb.process(x.astype(np.float32) * np.float32(1.0 / 32767.0))
        tmb.process_i16(x)
        jfm, jcam = (s.demod for s in jmb.states)
        assert pl.n - n_pl == int((np.asarray(jfm.pl_counter) == 0).any())
        assert acq.n - n_acq == int((np.asarray(jcam.fft_samples) == 0).any())
        np.testing.assert_array_equal(tmb.states[0].demod.pl_counter.numpy(),
                                      np.asarray(jfm.pl_counter))
        np.testing.assert_array_equal(
            tmb.states[1].demod.fft_samples.numpy(),
            np.asarray(jcam.fft_samples))
        if pl.n > n_pl:
            pl_fired.append(b)
        if acq.n > n_acq:
            acq_fired.append(b)
    assert pl_fired == [17, 26, 35] and acq_fired == [34]
