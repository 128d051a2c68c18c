"""The port's multi-device sharding (``ka9q_sdr_tpu_torch.parallel``)
against the JAX package's on the 8-virtual-device CPU mesh that
tests/conftest.py sets up; the port runs on 8 CPU shards of one process.

Geometry as tests/test_mesh.py: 1.536 Msps, L 3840, M 4353 (N = 8192,
N_dec 256, L_dec 120), 16 channels.  Inputs are made with numpy from fixed
seeds.

Tolerances, with their reasons:

- fft_fourstep, the distributed FFT: within 1e-6 (against JAX) and 2e-5
  (against numpy's float64 FFT) of the spectrum's peak: float32 rounding
  of the two FFT libraries.
- the sharded bank against JAX's sharded bank: the bounds of
  tests/test_mesh.py, which JAX holds its sharded bank to against its
  unsharded one (audio atol 2e-5 / rtol 1e-5, carried state atol 2e-5 /
  rtol 1e-4; shard_fft audio 3e-5 / 1e-4, state 3e-5 / 1e-3; shard_fft ISB
  1e-3 in block 0, where the hang AGC's attack on the strong carrier
  magnifies float rounding, 3e-5 after).  The AGC modes (CAM, ISB) from
  block 1 on: in block 0 the AGC's cold start lifts the two FFT libraries'
  rounding to 5e-3 of full scale (ROADMAP §3 item 5), as the port's other
  tests against JAX skip it.
- the port's sharded bank against its own unsharded bank: bit-equal for FM,
  AM, USB and ISB (every row takes the same ops); CAM within 1e-7 of the
  audio and two float32 ulps of the state, its NCO words within 16 counts
  of 2^32 (its PLL state differs by float32 rounding from the first block,
  5e-10 in the loop integrator, whose source was not isolated).  NCO words
  against JAX: within 2048 counts, four float32 ulps of a cycle.
- the comb layout through the comb slices: the same bins gathered as from
  the natural spectrum, bit-equal.
- MultiBank: 3e-4 / 1e-3, test_mesh.py's bound for the sharded MultiBank,
  from block 1 on (the AGC's cold start, as above).
- bankd PCM: FM within 1 LSB; the AM/linear groups within PARITY.md #9's
  8 LSB and -85 dBFS RMS from the second block (the AGC's cold start).
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from ka9q_sdr_tpu.apps import bankd as JD
from ka9q_sdr_tpu.models import bank as JB
from ka9q_sdr_tpu.ops.fftfilt import fft_fourstep as jax_fourstep
from ka9q_sdr_tpu.ops.packing import tree_c2r_np, tree_r2c
from ka9q_sdr_tpu.parallel import mesh as JM
from ka9q_sdr_tpu_torch.apps import bankd as TD
from ka9q_sdr_tpu_torch.interop import (sharded_state_from_jax,
                                        state_from_jax, state_to_numpy)
from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.ops.fftfilt import FOURSTEP_MIN, fft_fourstep
from ka9q_sdr_tpu_torch.parallel import mesh as TM
from ka9q_sdr_tpu_torch.parallel.dryrun import dryrun_multichip

# the packages export a function named dfft beside their module dfft
JDF = importlib.import_module("ka9q_sdr_tpu.parallel.dfft")
TDF = importlib.import_module("ka9q_sdr_tpu_torch.parallel.dfft")

torch.set_num_threads(1)

SAMPRATE = 1.536e6
L, M = 3840, 4353
N_CH, N_DEV = 16, 8


def _freqs(n):
    usable = 0.9 * SAMPRATE
    return list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))


def _blocks(freqs, n_blocks, seed=7):
    """Noise + two strong carriers, as (L, 2) float32 packed I/Q."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n_blocks * L) / SAMPRATE
    x = 0.01 * (rng.standard_normal(len(tt))
                + 1j * rng.standard_normal(len(tt)))
    for ch in (1, len(freqs) // 2):
        x += 0.3 * np.exp(2j * np.pi * freqs[ch] * tt)
    x = x.astype(np.complex64)
    xr = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return [xr[i * L:(i + 1) * L] for i in range(n_blocks)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_close(got, want, atol, rtol, words=2048):
    """Leaf by leaf: the uint32 NCO phase and frequency words within
    `words` counts of 2^32 (modulo the wrap), the others as float64."""
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


# ---- the four-step FFT and the distributed FFT ----

@pytest.mark.parametrize("log2n", [10, 16])
def test_fft_fourstep_matches_jax(log2n):
    rng = np.random.default_rng(log2n)
    z = (rng.standard_normal(1 << log2n)
         + 1j * rng.standard_normal(1 << log2n)).astype(np.complex64)
    got = fft_fourstep(torch.as_tensor(z)).numpy()
    want = np.asarray(jax.jit(jax_fourstep)(z))
    peak = np.abs(np.fft.fft(z.astype(np.complex128))).max()
    assert np.abs(got - want).max() < 1e-6 * peak
    assert np.abs(got - np.fft.fft(z.astype(np.complex128))).max() \
        < 2e-5 * peak
    assert FOURSTEP_MIN == 1 << 25


@pytest.mark.parametrize("log2n", [13, 16])
def test_dfft_matches_jax(log2n):
    N = 1 << log2n
    rng = np.random.default_rng(log2n + 1)
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)) \
        .astype(np.complex64)
    jmesh = JM.make_channel_mesh(N_DEV)
    tmesh = TM.make_channel_mesh(N_DEV, cpu=True)
    want_comb = np.asarray(JDF.make_dfft(jmesh, N)(jax.device_put(
        x, jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(
            "ch")))))
    got_comb = TDF.make_dfft(tmesh, N)(torch.as_tensor(x)).numpy()
    ref = np.fft.fft(x.astype(np.complex128))
    peak = np.abs(ref).max()
    assert np.abs(got_comb - want_comb).max() < 1e-6 * peak
    np.testing.assert_array_equal(TDF.comb_index(N, N_DEV),
                                  JDF.comb_index(N, N_DEV))
    np.testing.assert_array_equal(TDF.undo_comb(got_comb, N_DEV),
                                  JDF.undo_comb(got_comb, N_DEV))
    got = TDF.dfft(tmesh, x)
    assert np.abs(got - JDF.dfft(jmesh, x)).max() < 1e-6 * peak
    assert np.abs(got - ref).max() < 2e-5 * peak


@pytest.mark.parametrize("mode", ["FM", "ISB"])
@pytest.mark.parametrize("P", [2, 4, 8, 16])
def test_comb_layout_gathers_the_same_bins(mode, P):
    """bank_channelize from the natural spectrum and from the P comb slices
    of the comb-major one (comb_gather): the same bins, so bit-equal
    baseband."""
    cfg = TB.make_bank_config(24, mode, samprate=SAMPRATE, L=L, M=M)
    rng = np.random.default_rng(1)
    freqs = list(np.linspace(-0.45 * SAMPRATE, 0.45 * SAMPRATE, 24,
                             endpoint=False) + rng.uniform(-2000, 2000, 24))
    st = TB.bank_init(cfg, freqs, device="cpu")
    N = cfg.N
    fd = torch.as_tensor((rng.standard_normal(N) + 1j * rng.standard_normal(
        N)).astype(np.complex64))
    perm = TDF.comb_index(N, P)
    comb = torch.empty_like(fd)
    comb[torch.as_tensor(perm)] = fd
    cfg = cfg.to("cpu")
    _, _, nat = TB.bank_channelize(cfg, st, fd)
    slices = list(comb.reshape(P, N // P))
    _, _, via_slices = TB.bank_channelize(cfg, st, slices)
    assert torch.equal(via_slices, nat)


# ---- the sharded bank ----

def _jax_bank(mode):
    cfg = JB.make_bank_config(N_CH, mode, samprate=SAMPRATE, L=L, M=M)
    template = JB.bank_init(cfg, _freqs(N_CH))
    packed = tree_c2r_np(_np_tree(template))
    return cfg, template, packed


@pytest.mark.parametrize("mode,shard_fft", [
    ("FM", False), ("CAM", False), ("ISB", False), ("FM", True),
    ("ISB", True)])
def test_sharded_bank_matches_jax(mode, shard_fft):
    """5 blocks with a mid-run retune of channel 3 at block 2, the port's
    sharded step against JAX's make_sharded_bank_step, from one state."""
    freqs = _freqs(N_CH)
    jcfg, template, packed = _jax_bank(mode)
    jmesh = JM.make_channel_mesh(N_DEV)
    jstep, jstate = JM.make_sharded_bank_step(jcfg, jmesh, template, packed,
                                              shard_fft=shard_fft)
    tcfg = TB.make_bank_config(N_CH, mode, samprate=SAMPRATE, L=L, M=M)
    tmesh = TM.make_channel_mesh(N_DEV, cpu=True)
    tstep, _ = TM.make_sharded_bank_step(
        tcfg, tmesh, state_from_jax(_np_tree(template), device="cpu"),
        shard_fft=shard_fft)
    tstate = sharded_state_from_jax(_np_tree(template), tmesh)
    atol, rtol = (3e-5, 1e-4) if shard_fft else (2e-5, 1e-5)
    for blk, xr in enumerate(_blocks(freqs, 5)):
        if blk == 2:
            f = freqs[1] + 1000.0
            jstate = JB.bank_tune(jcfg, jstate, 3, f)
            tstate = TM.edit_channel(
                tstate, 3, lambda s, i: TB.bank_tune(tcfg, s, i, f))
        jstate, jaudio, _ = jstep(jstate, xr)
        tstate, taudio, _ = tstep(tstate, xr)
        if blk == 0 and mode != "FM" and not shard_fft:
            continue           # the AGC's cold start (module docstring)
        a_tol = 1e-3 if (mode == "ISB" and shard_fft and blk == 0) else atol
        np.testing.assert_allclose(taudio.numpy(), np.asarray(jaudio),
                                   atol=a_tol, rtol=rtol,
                                   err_msg=f"audio at block {blk}")
    s_atol, s_rtol = (3e-5, 1e-3) if shard_fft else (2e-5, 1e-4)
    _assert_state_close(state_to_numpy(TM.gather_bank_state(tstate)),
                        _np_tree(tree_r2c(jstate, template)), s_atol, s_rtol)


@pytest.mark.parametrize("mode", ["FM", "AM", "USB", "ISB", "CAM"])
def test_sharded_bank_matches_its_unsharded_bank(mode):
    """ChannelBank on the 8-shard mesh against ChannelBank on one device,
    int16 PCM ingest, with a retune, a Doppler steer and a filter swap."""
    freqs = _freqs(N_CH)
    cfg = TB.make_bank_config(N_CH, mode, samprate=SAMPRATE, L=L, M=M)
    a = TB.ChannelBank(cfg, freqs, mesh=TM.make_channel_mesh(N_DEV,
                                                             cpu=True))
    b = TB.ChannelBank(cfg, freqs, device="cpu")
    tol = 1e-7 if mode == "CAM" else 0.0
    for blk, xr in enumerate(_blocks(freqs, 5, seed=9)):
        x16 = np.clip(np.round(xr * 32767), -32768, 32767).astype(np.int16)
        if blk == 2:
            for bank in (a, b):
                bank.tune(11, freqs[1] + 500.0)
                bank.set_doppler(5, 100.0, -50.0)
                bank.set_filter(low=-4000.0, high=4000.0)
        aa, da = a.process_i16(x16)
        bb, db = b.process_i16(x16)
        assert float((aa - bb).abs().max()) <= tol, blk
        assert float((da["bb_power"] - db["bb_power"]).abs().max()) <= tol
    assert a.freqs == b.freqs and a.cfg.mode == b.cfg.mode
    _assert_state_close(state_to_numpy(TM.gather_bank_state(a.state)),
                        state_to_numpy(b.state), atol=tol,
                        rtol=2.5e-7 if mode == "CAM" else 0,
                        words=16 if mode == "CAM" else 0)


def test_sharded_state_round_trip_and_split():
    """shard_bank_state / gather_bank_state are inverses, and the split
    per leaf is JAX's bank_state_shardings (channel axis or replicated)."""
    jcfg, template, packed = _jax_bank("CAM")
    jsh = JM.bank_state_shardings(JM.make_channel_mesh(N_DEV), template)
    tmesh = TM.make_channel_mesh(N_DEV, cpu=True)
    state = state_from_jax(_np_tree(template), device="cpu")
    tsh = TM.bank_state_shardings(tmesh, state)
    for field in state._fields:
        j_ch = [bool(s.spec) and s.spec[0] == JM.CHANNEL_AXIS
                for s in jax.tree_util.tree_leaves(getattr(jsh, field))]
        t_ch = [s == TM.CHANNEL_AXIS for s in jax.tree_util.tree_leaves(
            getattr(tsh, field), is_leaf=lambda x: x is None)
            if s is not None or field in ("overlap", "resp", "gain_factor")]
        assert j_ch == t_ch, field
    shards = TM.shard_bank_state(tmesh, state)
    assert len(shards) == N_DEV and shards[0].k.shape == (N_CH // N_DEV,)
    back = TM.gather_bank_state(shards)
    for u, v in zip(jax.tree_util.tree_leaves(state_to_numpy(back)),
                    jax.tree_util.tree_leaves(state_to_numpy(state))):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("n", [12, 5])
def test_non_divisible_channel_count_is_an_explicit_error(n):
    cfg = TB.make_bank_config(n, "FM", samprate=SAMPRATE, L=L, M=M)
    mesh = TM.make_channel_mesh(N_DEV, cpu=True)
    with pytest.raises(ValueError, match="not divisible"):
        TM.make_sharded_bank_step(cfg, mesh, TB.bank_init(
            cfg, _freqs(n), device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        TB.ChannelBank(cfg, _freqs(n), mesh=mesh)


@pytest.mark.parametrize("n,d", [(5, 8), (8, 8), (13, 4), (1, 3), (16, 1)])
def test_pad_channels(n, d):
    freqs = _freqs(n)
    assert TM.pad_channels(freqs, d) == JM.pad_channels(freqs, d)


@pytest.mark.parametrize("max_active", [8, 3])
def test_active_compaction_never_reports_padding_rows(max_active):
    """process_active with n_valid on the mesh: padding rows never take a
    slot (idx -1 where they would), and the active set is JAX's."""
    n_real = 5
    freqs = TM.pad_channels(list(np.linspace(
        -0.4 * SAMPRATE, 0.4 * SAMPRATE, n_real, endpoint=False)), N_DEV)
    tcfg = TB.make_bank_config(N_DEV, "AM", samprate=SAMPRATE, L=L, M=M)
    jcfg = JB.make_bank_config(N_DEV, "AM", samprate=SAMPRATE, L=L, M=M)
    tbank = TB.ChannelBank(tcfg, freqs, mesh=TM.make_channel_mesh(
        N_DEV, cpu=True))
    jbank = JB.ChannelBank(jcfg, freqs, mesh=JM.make_channel_mesh(N_DEV))
    tt = np.arange(L) / SAMPRATE
    x = sum(0.2 * (1 + 0.5 * np.sin(2 * np.pi * 400 * tt))
            * np.exp(2j * np.pi * f * tt) for f in freqs[:n_real])
    xi = np.empty((L, 2), np.int16)
    xi[:, 0] = np.clip(x.real * 32767, -32768, 32767)
    xi[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
    for _ in range(3):
        _, tidx, _ = tbank.process_active(xi, max_active=max_active,
                                          n_valid=n_real)
        _, jidx, _ = jbank.process_active(xi, max_active=max_active,
                                          n_valid=n_real)
    tidx, jidx = tidx.numpy(), np.asarray(jidx)
    assert set(tidx[tidx >= 0]) <= set(range(n_real))
    assert np.sum(tidx >= 0) == min(max_active, n_real)
    assert set(tidx[tidx >= 0]) == set(jidx[jidx >= 0])


@pytest.mark.parametrize("max_active", [16, 6])
def test_sharded_active_matches_unsharded(max_active):
    """The sharded compaction (peaks gathered, rows fetched from their
    shards) gives the unsharded bank's PCM and indices bit for bit."""
    freqs = _freqs(N_CH)
    cfg = TB.make_bank_config(N_CH, "FM", samprate=SAMPRATE, L=L, M=M)
    a = TB.ChannelBank(cfg, freqs, mesh=TM.make_channel_mesh(4, cpu=True))
    b = TB.ChannelBank(cfg, freqs, device="cpu")
    for xr in _blocks(freqs, 3, seed=4):
        x16 = np.clip(np.round(xr * 32767), -32768, 32767).astype(np.int16)
        pa, ia, _ = a.process_active(x16, max_active, n_valid=13)
        pb, ib, _ = b.process_active(x16, max_active, n_valid=13)
        assert torch.equal(ia, ib) and torch.equal(pa, pb)
    assert (ia >= 0).any()


# ---- MultiBank ----

@pytest.mark.parametrize("groups", [
    (("FM", 5, -0.45, 0.0), ("CAM", 3, 0.01, 0.45)),
    (("AM", 3, -0.45, 0.0), ("USB", 2, 0.01, 0.1))])
def test_multibank_mesh_matches_jax(groups):
    """MultiBank(mesh=) against JAX's: groups padded to the mesh each, a
    retune and a group filter swap on the sharded state mid-run."""
    spec = [(mode, list(np.linspace(lo * SAMPRATE, hi * SAMPRATE, n,
                                    endpoint=False)))
            for mode, n, lo, hi in groups]
    t = TB.MultiBank(spec, samprate=SAMPRATE, L=L, M=M,
                     mesh=TM.make_channel_mesh(N_DEV, cpu=True))
    j = JB.MultiBank(spec, samprate=SAMPRATE, L=L, M=M,
                     mesh=JM.make_channel_mesh(N_DEV))
    assert t.group_real == j.group_real == [n for _, n, _, _ in groups]
    assert [c.n_channels for c in t.cfgs] == [N_DEV, N_DEV]
    f_new = 2.2e5
    rng = np.random.default_rng(3)
    for blk in range(5):
        tt = (blk * L + np.arange(L)) / SAMPRATE
        x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        x = x + 0.3 * np.exp(2j * np.pi * spec[0][1][2] * tt) \
            + 0.2 * np.exp(2j * np.pi * (f_new + 1000.0) * tt)
        x = x.astype(np.complex64)
        if blk == 2:
            for mb in (t, j):
                mb.tune(1, 1, f_new)
                mb.set_filter(1, low=50.0, high=2800.0)
        outs_t, outs_j = t.process(x), j.process(x)
        if blk == 0:
            continue               # the AGC's cold start (module docstring)
        for g, ((at, _), (aj, _)) in enumerate(zip(outs_t, outs_j)):
            n = t.group_real[g]
            np.testing.assert_allclose(
                at.numpy()[:n], np.asarray(aj)[:n], atol=3e-4, rtol=1e-3,
                err_msg=f"group {g} at block {blk}")
    assert len(t.states[1]) == N_DEV      # still split over the mesh
    assert t.group_freqs == j.group_freqs


# ---- bankd --mesh ----

def _write_iq(path, n_blocks, carriers, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(n_blocks * L) / SAMPRATE
    x = 0.003 * (rng.standard_normal(len(tt))
                 + 1j * rng.standard_normal(len(tt)))
    for f, kind in carriers:
        if kind == "fm":
            x = x + 0.3 * np.exp(1j * (2 * np.pi * f * tt + 7.5 * np.sin(
                2 * np.pi * 400 * tt)))
        else:
            x = x + 0.2 * np.exp(2j * np.pi * f * tt)
    iq = np.empty((len(x), 2), np.int16)
    iq[:, 0] = np.clip(np.round(x.real * 32767), -32768, 32767)
    iq[:, 1] = np.clip(np.round(x.imag * 32767), -32768, 32767)
    iq.tofile(path)


@pytest.mark.parametrize("kind", ["iq-file", "iq-file-shard-fft",
                                  "channel-file"])
def test_bankd_mesh_matches_jax(tmp_path, capsys, kind):
    """main() --mesh 8 of both daemons on one recording: 10 channels padded
    to 16 (the mixed-mode daemon pads each group), no padding row written
    to --pcm-raw."""
    f = _freqs(10)
    path = tmp_path / "in.iq"
    _write_iq(path, 6, [(f[1], "fm"), (f[7], "fm"), (f[8] + 900.0, "tone")],
              seed=2)
    argv = ["--iq-file", str(path), "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--mesh", str(N_DEV)]
    if kind == "channel-file":
        chf = tmp_path / "ch.txt"
        chf.write_text("".join(f"{x} FM\n" for x in f[:8])
                       + f"{f[8]} USB\n{f[9]} USB\n")
        argv += ["--channel-file", str(chf)]
    else:
        argv += ["--channels", "10", "-m", "FM"]
    if kind == "iq-file-shard-fft":
        argv.append("--shard-fft")
    for mod, tag, extra in ((TD, "port", ["--cpu"]), (JD, "jax", [])):
        rc = mod.main(argv + extra + ["--pcm-raw", str(tmp_path / tag)])
        assert rc == 0
    err = capsys.readouterr().err
    assert "bankd: --mesh 8: a 8-device mesh (cpu, cpu" in err
    got, want = (np.fromfile(tmp_path / t, "<i2").reshape(6, -1)
                 .astype(np.int64) for t in ("port", "jax"))
    if kind == "channel-file":
        assert "padded" not in err         # MultiBank pads silently
        # per block: the FM group's 8 rows, then the USB group's 2
        got, want = got.reshape(6, 10, -1), want.reshape(6, 10, -1)
        assert np.abs(got[:, :8] - want[:, :8]).max() <= 1
        d = (got[1:, 8:] - want[1:, 8:]).astype(np.float64)
        assert np.abs(d).max() <= 8
        assert np.sqrt(np.mean(d ** 2)) / 32768.0 <= 10 ** (-85 / 20)
        assert np.abs(got[2:, 8]).max() > 1000     # the USB tone
    else:
        assert "bankd: padded 10 channels to 16 for the 8-device mesh" in err
        assert got.shape == (6, 10 * 120)
        assert np.abs(got - want).max() <= 1
        assert np.abs(got.reshape(6, 10, -1)[2:, [1, 7]]).max() > 1000


def test_bankd_mesh_on_fewer_devices_than_asked(capsys):
    """--mesh 2 without --cpu on a machine with no card: the mesh it gets
    is printed, or, with no device at all, the daemon exits."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        TD.main(["--iq-file", "x", "--channels", "2", "--mesh", "2"])
    with pytest.raises(ValueError, match="at least one device"):
        TM.make_channel_mesh(2)


def test_dryrun_multichip_on_cpu_shards(capsys):
    dryrun_multichip(N_DEV, cpu=True)
    out = capsys.readouterr().out
    for label in ("FM", "CAM", "bigN", "shard_fft", "shard_fft+bigN",
                  "fft_fourstep", f"bankd --mesh {N_DEV}", "MultiBank",
                  "doppler", "shard_fft+ISB", "migrate"):
        assert f"dryrun_multichip {label} OK" in out, label


def test_dryrun_needs_a_card_without_cpu(capsys):
    """Without --cpu the dry run shards over the cards or runs nothing: it
    never falls back to CPU shards."""
    from ka9q_sdr_tpu_torch.parallel import dryrun

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["2"])
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


def test_bankd_mesh_live_migration_matches_jax(tmp_path, capsys):
    """The mixed-mode daemon on a 4-device mesh (groups of 3 and 2 slots
    padded to 4), FM -> USB migration by a RADIO_MODE command mid-run, the
    port's against the JAX package's: the same slot maps and messages, FM
    rows within 1 LSB, USB rows within PARITY.md #9 from block 1."""
    from ka9q_sdr_tpu.net import status as st
    from ka9q_sdr_tpu.net.status import StatusType

    cmd = bytearray([1])
    st.encode_int(cmd, StatusType.OUTPUT_SSRC, 2)
    st.encode_string(cmd, StatusType.RADIO_MODE, b"USB")
    st.encode_eol(cmd)
    rng = np.random.default_rng(20261019)
    blocks = []
    for b in range(8):
        t = (b * L + np.arange(L)) / SAMPRATE
        blocks.append((0.003 * (rng.standard_normal(L)
                                + 1j * rng.standard_normal(L))
                       + 0.3 * np.exp(2j * np.pi * (150e3 + 1e3) * t)
                       + 0.3 * np.exp(2j * np.pi * (400e3 + 700.0) * t))
                      .astype(np.complex64))
    runs = {}
    for mod, tag, extra in ((TD, "port", ["--cpu"]), (JD, "jax", [])):
        args = mod.build_parser().parse_args(
            ["-r", str(SAMPRATE), "--L", str(L), "--M", str(M), "--no-native",
             "--spare-slots", "1", "--mesh", "4",
             "--pcm-raw", str(tmp_path / tag), *extra])
        d = mod.MultiBankDaemon(args, [("FM", [-300e3, 150e3, 0.0]),
                                       ("USB", [400e3, 0.0])])
        capsys.readouterr()
        for b, blk in enumerate(blocks):
            if b == 4:
                d.handle_command(bytes(cmd))
            d.process_block(blk)
        d.close()
        runs[tag] = (d, capsys.readouterr().err.splitlines())
    (dt, et), (dj, ej) = runs["port"], runs["jax"]
    assert et == ej and any("migrated ssrc 2 FM->USB" in x for x in et)
    assert dt.ssrc_map == dj.ssrc_map and dt.slot_ssrc == dj.slot_ssrc
    assert [c.n_channels for c in dt.mb.cfgs] == [4, 4]
    got, want = (np.fromfile(tmp_path / t, "<i2").reshape(8, 5, -1)
                 .astype(np.int64) for t in ("port", "jax"))
    assert np.abs(got[:, :3] - want[:, :3]).max() <= 1
    d = (got[1:, 3:] - want[1:, 3:]).astype(np.float64)
    assert np.abs(d).max() <= 8
    assert np.sqrt(np.mean(d ** 2)) / 32768.0 <= 10 ** (-85 / 20)
    assert np.sqrt(np.mean(got[6:, 4].astype(np.float64) ** 2)) > 200
