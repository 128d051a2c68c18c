"""The distributed-master-FFT mesh step (``shard_fft``) as the port runs it:
the halves of ``parallel.dfft`` that each run on one device, and the bank's
step as a chain of per-device links (``utils.graphs.MeshGraphs``), on 8 CPU
shards of one process against the JAX package's ``shard_fft`` step on
tests/conftest.py's 8 virtual CPU devices.  On the CPU every link runs
eagerly, through the same code the card captures; the card's twins of
these cases are in tests/test_torch_graphs_cuda.py.

Geometry as tests/test_torch_parallel.py: 1.536 Msps, L 3840, M 4353
(N = 8192, N_dec 256, L_dec 120), 16 channels.  Inputs are made with numpy
from fixed seeds.

Tolerances, with their reasons:

- the halves against the single functions they were split from (private
  copies below, as the parent tree had them): bit-equal, the same
  operations in the same order (the reduce-scatter's sum in device order).
- ``make_dfft`` against JAX's: within 1e-6 of the spectrum's peak and its
  comb layout against numpy's float64 FFT within 2e-5, the bounds of
  test_torch_parallel.py's ``test_dfft_matches_jax``.
- the bank against JAX's ``shard_fft`` bank: test_torch_parallel.py's
  stated bounds, audio atol 3e-5 / rtol 1e-4 (ISB's block 0 1e-3, where
  the hang AGC's attack on the strong carrier magnifies float rounding;
  CAM from block 1, the AGC's cold start), carried state 3e-5 / 1e-3, NCO
  words within 2048 counts of 2^32.
- the scan of a ``shard_fft`` bank: JAX compiles a mesh bank's
  ``process_scan_i16`` with the replicated master FFT, whatever
  ``shard_fft`` says, and so does the port: the same bounds against JAX,
  and bit-equal to the port's replicated mesh bank from the same state.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from ka9q_sdr_tpu.models import bank as JB
from ka9q_sdr_tpu.ops.packing import tree_r2c
from ka9q_sdr_tpu.parallel import mesh as JM
from ka9q_sdr_tpu_torch.interop import state_to_numpy
from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.parallel import mesh as TM
from ka9q_sdr_tpu_torch.utils.graphs import MeshGraphs, fetch

# the packages export a function named dfft beside their module dfft
JDF = importlib.import_module("ka9q_sdr_tpu.parallel.dfft")
TDF = importlib.import_module("ka9q_sdr_tpu_torch.parallel.dfft")

torch.set_num_threads(1)

SAMPRATE = 1.536e6
L, M = 3840, 4353
N_CH, N_DEV = 16, 8


def _old_make_dfft_sm(mesh, N):
    """parallel/dfft.py's make_dfft_sm before its split into halves."""
    P = mesh.size
    Q = N // P
    j = np.arange(P)
    WP = np.exp(-2j * np.pi * np.outer(j, j) / P).astype(np.complex64)
    cols = [torch.as_tensor(WP[:, p], device=dev)
            for p, dev in enumerate(mesh.devices)]
    q = torch.arange(Q, dtype=torch.float32)
    tws = [torch.exp((-2j * np.pi / N) * (float(jj) * q)).to(dev)
           for jj, dev in enumerate(mesh.devices)]
    local_fft = TDF.fft_fourstep if Q >= TDF.FOURSTEP_MIN else (
        lambda y: torch.fft.fft(y, dim=-1))

    def fn(parts):
        z = [col[:, None] * x[None, :] for col, x in zip(cols, parts)]
        combs = []
        for jj, dev in enumerate(mesh.devices):
            y = z[0][jj].to(dev)
            for zp in z[1:]:
                y = y + zp[jj].to(dev)
            combs.append(local_fft(y * tws[jj]))
        return combs

    return fn


def _old_comb_gather(combs, idx):
    """parallel/dfft.py's comb_gather before its split into halves."""
    P = len(combs)
    B, n_dec = idx.shape
    dev = idx.device
    idx3 = idx.reshape(B, n_dec // P, P)
    out = torch.empty((B, n_dec // P, P), dtype=torch.complex64, device=dev)
    for j, comb in enumerate(combs):
        r = ((j - idx[:, 0]) % P)[:, None, None].expand(B, n_dec // P, 1)
        pos = torch.gather(idx3, 2, r) // P
        out.scatter_(2, r, comb[pos.to(comb.device)].to(dev))
    return out.reshape(B, n_dec)


def _bits(t):
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _freqs(n):
    usable = 0.9 * SAMPRATE
    return list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))


@pytest.mark.parametrize("log2n,P", [(13, 8), (16, 4), (16, 8)])
def test_dfft_halves_equal_the_single_function(log2n, P):
    """partials and combine, composed by make_dfft_sm and by make_dfft's
    chain of links, bit-equal to the unsplit function; make_dfft within
    test_dfft_matches_jax's bounds of JAX's jitted make_dfft."""
    N = 1 << log2n
    Q = N // P
    rng = np.random.default_rng(log2n + P)
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)) \
        .astype(np.complex64)
    mesh = TM.make_channel_mesh(P, cpu=True)
    xt = torch.as_tensor(x)
    parts = [xt[p * Q:(p + 1) * Q] for p in range(P)]
    want = _old_make_dfft_sm(mesh, N)(parts)
    got = TDF.make_dfft_sm(mesh, N)(parts)
    assert all(_equal(g, w) for g, w in zip(got, want))
    comb = TDF.make_dfft(mesh, N)(x)
    assert _equal(comb, torch.cat(want))
    assert all(g.replays == 0 for g in TDF.make_dfft(mesh, N).graphs.shards)
    jmesh = JM.make_channel_mesh(P)
    want_comb = np.asarray(JDF.make_dfft(jmesh, N)(jax.device_put(
        x, jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(
            "ch")))))
    ref = np.fft.fft(x.astype(np.complex128))
    peak = np.abs(ref).max()
    assert np.abs(comb.numpy() - want_comb).max() < 1e-6 * peak
    assert np.abs(TDF.undo_comb(comb.numpy(), P) - ref).max() < 2e-5 * peak


@pytest.mark.parametrize("mode", ["FM", "ISB"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_comb_gather_halves_equal_the_single_function(mode, P):
    """comb_positions on the destination, the take on each comb slice and
    comb_assemble back on the destination, as the chain's links run them,
    bit-equal to the unsplit comb_gather, for channels spread over the
    band with hopped k."""
    cfg = TB.make_bank_config(24, mode, samprate=SAMPRATE, L=L, M=M)
    rng = np.random.default_rng(P)
    freqs = list(np.linspace(-0.45 * SAMPRATE, 0.45 * SAMPRATE, 24,
                             endpoint=False) + rng.uniform(-2000, 2000, 24))
    st = TB.bank_init(cfg, freqs, device="cpu")
    st = st._replace(k=(st.k + torch.as_tensor(
        rng.integers(-3, 4, 24), dtype=torch.int32)) % cfg.N)
    combs = list(torch.as_tensor((rng.standard_normal(cfg.N)
                                  + 1j * rng.standard_normal(cfg.N))
                                 .astype(np.complex64)).reshape(P, -1))
    idx = TB._gather_index(cfg.to("cpu"), st)
    want = _old_comb_gather(combs, idx)
    assert _equal(TDF.comb_gather(combs, idx), want)
    pos = TDF.comb_positions(idx, P)
    assert pos.shape == (P, 24, cfg.N_dec // P, 1)
    parts = [comb[fetch(pos[j], "cpu")] for j, comb in enumerate(combs)]
    assert _equal(TDF.comb_assemble(parts, idx), want)


def test_mesh_graphs_chain_runs_its_links_in_order():
    """MeshGraphs.chain on CPU shards: link 0 on each shard's input, link
    i > 0 on every shard's outputs of link i - 1, the state written by
    each link, the last link's outputs returned."""
    mg = MeshGraphs(["cpu"] * 3)
    states = [(torch.zeros(3),) for _ in range(3)]
    links = (lambda d: lambda s, x: ((s[0] + x,), x * (d + 1)),
             lambda j: lambda s, prev: (s, sum(p[j] for p in prev)),
             lambda d: lambda s, prev: ((s[0] * 10,), torch.stack(prev)))
    xs = [torch.full((3,), float(d + 1)) for d in range(3)]
    out = mg.chain("k", links, states, xs)
    # link 0: (d + 1)^2 on shard d; link 1: shard j sums element j
    assert all(torch.equal(o, torch.full((3,), 14.0)) for o in out)
    assert [s[0].tolist() for s in states] == [[10.0] * 3, [20.0] * 3,
                                               [30.0] * 3]
    assert all(g.replays == 0 for g in mg.shards)


def _jax_bank(mode):
    cfg = JB.make_bank_config(N_CH, mode, samprate=SAMPRATE, L=L, M=M,
                              enable_pl=mode == "FM")
    return JB.ChannelBank(cfg, _freqs(N_CH), mesh=JM.make_channel_mesh(N_DEV),
                          shard_fft=True)


def _port_bank(mode, shard_fft=True):
    cfg = TB.make_bank_config(N_CH, mode, samprate=SAMPRATE, L=L, M=M,
                              enable_pl=mode == "FM")
    return TB.ChannelBank(cfg, _freqs(N_CH),
                          mesh=TM.make_channel_mesh(N_DEV, cpu=True),
                          shard_fft=shard_fft)


def _blocks(n, seed):
    """Noise, two strong carriers and one on the steered channel, as
    (L, 2) int16."""
    freqs = _freqs(N_CH)
    rng = np.random.default_rng(seed)
    tt = np.arange(n * L) / SAMPRATE
    x = 0.01 * (rng.standard_normal(len(tt))
                + 1j * rng.standard_normal(len(tt)))
    for ch, a in ((1, 0.3), (N_CH // 2, 0.3), (5, 0.1)):
        x = x + a * np.exp(2j * np.pi * freqs[ch] * tt)
    xr = np.stack([x.real, x.imag], axis=-1) * 32767
    x16 = np.clip(np.round(xr), -32768, 32767).astype(np.int16)
    return [x16[i * L:(i + 1) * L] for i in range(n)]


def _edit(bank, blk, freqs):
    """The live edits: a retune, a Doppler step whose sweep hops k, and a
    filter swap (JAX's jitted step keeps its FM gain across set_filter,
    ROADMAP §3, so the JAX bank traces its step again)."""
    if blk == 2:
        bank.tune(3, freqs[1] + 1000.0)
    if blk == 3:
        bank.set_doppler(5, 3000.0, 20000.0)
    if blk == 5:
        bank.set_filter(low=-4000.0, high=4000.0)
        if hasattr(bank, "_step_i16"):
            del bank._step_i16


def _assert_state_close(got, want, atol, rtol, words=2048):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.uint32:
            d = (a.astype(np.int64) - b.astype(np.int64)) % (1 << 32)
            assert np.minimum(d, (1 << 32) - d).max() <= words
        else:
            np.testing.assert_allclose(a.astype(np.complex128),
                                       b.astype(np.complex128),
                                       atol=atol, rtol=rtol)


@pytest.mark.parametrize("mode", ["FM", "CAM", "ISB"])
def test_shard_fft_bank_matches_jax(mode):
    """ChannelBank(mesh=, shard_fft=True) against JAX's, 8 blocks of int16
    through a retune, a Doppler step and a filter swap, then a 3-block
    scan; the port's scan is also bit-equal to its replicated mesh bank's
    from the same state."""
    freqs = _freqs(N_CH)
    j, t = _jax_bank(mode), _port_bank(mode)
    blocks = _blocks(11, seed=21)
    first = 1 if mode == "CAM" else 0
    for blk, x in enumerate(blocks[:8]):
        for bank in (j, t):
            _edit(bank, blk, freqs)
        ja, _ = j.process_i16(x)
        ta, _ = t.process_i16(x)
        if blk < first:
            continue           # the AGC's cold start (module docstring)
        atol = 1e-3 if (mode == "ISB" and blk == 0) else 3e-5
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=atol,
                                   rtol=1e-4, err_msg=f"audio at block {blk}")
    if mode == "FM":
        assert t.cfg.demod_cfg.gain == j.cfg.demod_cfg.gain
    _assert_state_close(
        state_to_numpy(TM.gather_bank_state(t.state)),
        jax.tree_util.tree_map(np.asarray, tree_r2c(j.state, j._template)),
        3e-5, 1e-3)
    rep = _port_bank(mode, shard_fft=False)
    rep.set_filter(low=-4000.0, high=4000.0)
    rep.state = t.state
    xs = np.stack(blocks[8:])
    ja = np.asarray(j.process_scan_i16(xs))
    ta = t.process_scan_i16(xs)
    np.testing.assert_allclose(ta.numpy(), ja, atol=3e-5, rtol=1e-4)
    assert _equal(ta, rep.process_scan_i16(xs))
    assert all(_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(t.state),
        jax.tree_util.tree_leaves(rep.state)))


def _assert_pcm_close(a, b, lsb, rms_dbfs=None):
    d = a.numpy().astype(np.int64) - np.asarray(b).astype(np.int64)
    assert np.abs(d).max() <= lsb, np.abs(d).max()
    if rms_dbfs is not None:
        rms = np.sqrt(np.mean(d.astype(np.float64) ** 2)) / 32768.0
        assert rms <= 10 ** (rms_dbfs / 20), rms


@pytest.mark.parametrize("mode", ["FM", "CAM", "ISB"])
def test_shard_fft_active_is_the_replicated_step(mode):
    """process_active on a shard_fft bank runs the replicated per-shard
    step, as JAX compiles a mesh bank's ``bank_step_active`` whatever
    shard_fft says: bit-equal to the replicated mesh bank (PCM, indices,
    diag and state) over 6 blocks with a retune, and against JAX's
    ``ChannelBank(mesh, shard_fft=True).process_active`` the same indices
    and PCM within the replicated bank's bounds (the audio's 3e-5, 1 LSB;
    the AGC modes PARITY.md #9 from block 1, the cold start)."""
    freqs = _freqs(N_CH)
    j, t, rep = _jax_bank(mode), _port_bank(mode), _port_bank(mode, False)
    for blk, x in enumerate(_blocks(6, seed=23)):
        if blk == 2:
            for bank in (j, t, rep):
                bank.tune(3, freqs[1] + 1000.0)
        got = t.process_active(x, max_active=4, n_valid=15)
        want = rep.process_active(x, max_active=4, n_valid=15)
        assert _equal(got[0], want[0]) and _equal(got[1], want[1])
        assert all(_equal(got[2][k], want[2][k]) for k in want[2])
        jp, ji, _ = j.process_active(x, max_active=4, n_valid=15)
        assert got[1].tolist() == np.asarray(ji).tolist()
        if mode == "FM":
            _assert_pcm_close(got[0], jp, 1)
        elif blk >= 1:
            _assert_pcm_close(got[0], jp, 8, -85.0)
    assert (got[1] >= 0).sum() == 4
    assert all(_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(t.state),
        jax.tree_util.tree_leaves(rep.state)))
    _assert_state_close(
        state_to_numpy(TM.gather_bank_state(t.state)),
        jax.tree_util.tree_map(np.asarray, tree_r2c(j.state, j._template)),
        3e-5, 1e-3)
