"""Parity of the port's complex notch, ``parallel.dryrun.entry()`` and
``ops.pstock.stockham_rows_np`` against the JAX package on the CPU.

Tolerances, with their reasons:

- notch against JAX's notch: RMS error within 1e-5 of the output's RMS and
  the carried ``dcstate`` within 1e-5 of its magnitude; measured by these
  comparisons on the CPU: 5.9e-8 to 6.7e-8 of the RMS and 4.8e-8 to 1.5e-7
  of ``dcstate`` over the three (f, bw) cases.  The port's Hillis-Steele scan combines in another tree
  than JAX's ``associative_scan``; the oscillator words are bit-exact.
- notch against the compiled C notch (filter.c:551-571): 1e-4 of the RMS,
  the JAX package's own bound (``tests/test_c_dsp_parity.py``); skipped
  where the C reference cannot be built, as that test is.
- ``entry("cpu")`` against ``__graft_entry__.entry()``: the audio within
  1e-5 x max(peak, 1), the FM bank's bound (``tests/test_torch_bank.py``),
  and the squelch exactly.  The blocks are the example block (DC at 0.1)
  plus complex noise at 1e-3 from a numpy seed, so every channel has a
  noise floor.  On the bare example block, only the channel that holds
  the DC (channel 8) carries signal; the other 15 carry filter leakage and
  then FFT rounding alone.  The CPU FFTs round differently there: JAX's
  leaves exact zeros in every bin but DC, torch's (MKL) leaves rounding
  there.  From block 2 on, JAX's empty channels have zero power and a shut
  squelch; the port's have a rounding's power, no noise, and an open
  squelch that demodulates the rounding.  So the bare
  block is held at the bound on every channel in block 0, and on
  channel 8 in all three blocks.
- ``stockham_rows_np``: bit for bit (the same numpy code).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from ka9q_sdr_tpu.ops import iir as JI
from ka9q_sdr_tpu.ops import pstock as JP
from ka9q_sdr_tpu.ops.packing import tree_r2c
from ka9q_sdr_tpu_torch import ops as TO
from ka9q_sdr_tpu_torch.interop import state_to_numpy
from ka9q_sdr_tpu_torch.ops import iir as TI
from ka9q_sdr_tpu_torch.ops import pstock as TP
from ka9q_sdr_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

NOTCH_CASES = [(0.05, 0.01), (0.1, 0.005), (-0.2, 0.02)]


def _cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _port_notch(x, f, bw, block=512):
    st = TI.notch_init(f, bw, device="cpu")
    outs = []
    for i in range(0, x.shape[-1], block):
        st, y = TI.notch_block(st, torch.as_tensor(x[..., i:i + block]))
        outs.append(y.numpy())
    return st, np.concatenate(outs, axis=-1)


def _rms(a):
    return float(np.sqrt(np.mean(np.abs(a) ** 2)))


@pytest.mark.parametrize("f,bw", NOTCH_CASES)
def test_notch_matches_jax(f, bw):
    """2048 samples in blocks of 512, the state carried."""
    x = _cnoise(np.random.default_rng(23), 2048)
    js = JI.notch_init(f, bw)
    jo = []
    for i in range(0, len(x), 512):
        js, y = JI.notch_block(js, jnp.asarray(x[i:i + 512]))
        jo.append(np.asarray(y))
    jo = np.concatenate(jo)
    ts, to = _port_notch(x, f, bw)
    assert to.dtype == np.complex64 and to.shape == jo.shape
    assert _rms(to - jo) <= 1e-5 * _rms(jo)
    jdc = complex(js.dcstate)
    assert ts.dcstate.dtype == torch.complex64 and ts.dcstate.shape == ()
    assert abs(complex(ts.dcstate) - jdc) <= 1e-5 * abs(jdc)
    assert ts.bw == float(js.bw)
    for a, b in zip(ts.osc, js.osc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_notch_batch_axis():
    """A state built with a batch shape runs each row as its own notch,
    equal to the scalar notch on that row; a scalar state broadcasts over
    a batched block as JAX's does."""
    x = _cnoise(np.random.default_rng(5), (3, 1024))
    st = TI.notch_init(0.1, 0.005, (3,), device="cpu")
    outs = []
    for i in range(0, 1024, 256):
        st, y = TI.notch_block(st, torch.as_tensor(x[:, i:i + 256]))
        outs.append(y.numpy())
    got = np.concatenate(outs, axis=-1)
    assert st.dcstate.shape == (3,) and st.osc.phase.shape == (3,)
    for r in range(3):
        rs, ro = _port_notch(x[r], 0.1, 0.005, block=256)
        np.testing.assert_array_equal(got[r], ro)
        assert complex(st.dcstate[r]) == complex(rs.dcstate)
    js, jo = JI.notch_block(JI.notch_init(0.1, 0.005), jnp.asarray(x))
    ts, to = TI.notch_block(TI.notch_init(0.1, 0.005, device="cpu"),
                            torch.as_tensor(x))
    assert ts.dcstate.shape == np.asarray(js.dcstate).shape == (3,)
    assert _rms(to.numpy() - np.asarray(jo)) <= 1e-5 * _rms(np.asarray(jo))


def test_notch_vs_compiled_c():
    """The per-sample C notch (filter.c:551-571) at the JAX package's own
    bound."""
    import c_ref

    cref = c_ref.get_cref()
    if cref is None:
        pytest.skip("the C reference cannot be built (no gcc or no reference sources)")
    x = _cnoise(np.random.default_rng(23), 2048)
    y_c = cref.notch_run(0.05, 0.01, x)
    _, y_p = _port_notch(x, 0.05, 0.01)
    assert _rms(y_p - y_c) < 1e-4 * _rms(y_c)


def test_notch_removes_tone():
    """A tone at the notch frequency goes; the noise passes."""
    f = 0.1
    n = np.arange(20000)
    rng = np.random.default_rng(0x9A9)
    x = (np.exp(2j * np.pi * f * n) + 0.1 * (rng.standard_normal(len(n))
         + 1j * rng.standard_normal(len(n)))).astype(np.complex64)
    st = TO.notch_init(f, 0.005, device="cpu")
    st, y = TO.notch_block(st, torch.as_tensor(x))
    y = y.numpy()[5000:]
    spec = np.abs(np.fft.fft(y))
    assert spec[int(round(f * len(y)))] < 0.05 * len(y) ** 0.5 * 10
    # the noise keeps its power (0.02 per sample)
    assert 0.015 < np.mean(np.abs(y) ** 2) < 0.025


def _jax_entry():
    fn, (packed, x) = graft.entry()
    return jax.jit(fn), packed, x


def _audio_bound(ja):
    return 1e-5 * max(float(np.abs(ja).max()), 1.0)


def test_entry_matches_jax():
    """3 blocks of the example block plus noise, JAX's packed state fed
    back to JAX's step, the port's state to the port's."""
    jfn, packed, xr = _jax_entry()
    fn, (st, x) = dryrun.entry("cpu")
    np.testing.assert_array_equal(x.numpy(), xr[:, 0] + 1j * xr[:, 1])
    rng = np.random.default_rng(0)
    for _ in range(3):
        xb = xr + 1e-3 * rng.standard_normal(xr.shape).astype(np.float32)
        packed, ja, jd = jfn(packed, xb)
        st, ta, td = fn(st, torch.as_tensor(xb[:, 0] + 1j * xb[:, 1]))
        ja = np.asarray(ja)
        assert ta.shape == ja.shape == (16, 120)
        assert np.abs(ta.numpy() - ja).max() <= _audio_bound(ja)
        np.testing.assert_array_equal(td["squelch_open"].numpy(),
                                      np.asarray(jd["squelch_open"]))


def test_entry_example_block():
    """The example block itself: the same first state as JAX's, and the
    audio at the bound where the block carries signal (see the module
    docstring)."""
    jfn, packed, xr = _jax_entry()
    _, template, _, _ = graft._bank(16)
    fn, (st, x) = dryrun.entry("cpu")
    assert fn.bank.cfg.N == 8192
    want = jax.tree_util.tree_leaves(tree_r2c(packed, template))
    got = jax.tree_util.tree_leaves(state_to_numpy(st))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    for blk in range(3):
        packed, ja, jd = jfn(packed, xr)
        st, ta, td = fn(st, x)
        ja, ta = np.asarray(ja), ta.numpy()
        bound = _audio_bound(ja)
        rows = range(16) if blk == 0 else [8]
        for ch in rows:
            assert np.abs(ta[ch] - ja[ch]).max() <= bound, (blk, ch)
        # the carrier's channel: squelch open, its power as JAX's
        assert bool(td["squelch_open"][8]) and bool(jd["squelch_open"][8])
        jp = float(jd["bb_power"][8])
        assert abs(float(td["bb_power"][8]) - jp) <= 1e-5 * jp


def test_entry_state_is_the_callers():
    """The state fn returns is a copy: holding it across blocks and feeding
    it back replays the same block."""
    fn, (st0, x) = dryrun.entry("cpu")
    st1, a1, _ = fn(st0, x)
    st2, _, _ = fn(st1, x)
    _, again, _ = fn(st0, x)
    np.testing.assert_array_equal(again.numpy(), a1.numpy())
    assert st1.overlap.data_ptr() != st2.overlap.data_ptr()


def test_entry_needs_a_card_or_the_cpu():
    """entry() never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()


@pytest.mark.parametrize("Q,W", [(1, 3), (16, 3), (1024, 3), (64, 5)])
def test_stockham_rows_np_matches_jax(Q, W):
    rng = np.random.default_rng(Q + W)
    x = rng.standard_normal((Q, W)) + 1j * rng.standard_normal((Q, W))
    np.testing.assert_array_equal(TP.stockham_rows_np(x),
                                  JP.stockham_rows_np(x))
    assert TO.stockham_rows_np is TP.stockham_rows_np
