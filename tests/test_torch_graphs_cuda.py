"""The captured CUDA graphs of the port's host wrappers against their eager
twins (``capture=False``), bit for bit, on the card.

Every case needs a CUDA device and skips without one; the file imports no
jax, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py

Each case drives a captured wrapper and its eager twin with the same
numpy-seeded int16 blocks and the same live edits (a retune, a Doppler
steer, a filter swap that changes the FM gain), and holds audio,
diagnostics and the whole state equal bit for bit: the graph replays the
same kernels in the same order.  It also checks one replay per call, the
kernel launch counts per replay, and that what a call returned survives
the replays that follow.  Geometry as tests/test_torch_graphs.py (8
channels at 1.536 Msps, L = 30720, M = 34817; the receiver at 192 kHz).
The ``graphs.cond`` cases hold its IF node to the eager branch, a 40-block
FM+PL scan (two PL firings) to single replays and the eager twin, and a
MultiBank re-commissioning an FM row to its eager twin past the first
carrier search.  The ``shard_fft`` cases run the distributed-master-FFT
bank and ``make_dfft`` as chains of per-device graphs
(``graphs.MeshGraphs``) on 4 shards: the machine's first 4 cards where it
has them (the peer copies are then memcpy nodes), else 4 shards of the
card.
"""

import gc
import importlib

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.models import demod_fm
from ka9q_sdr_tpu_torch.models import receiver as TR
from ka9q_sdr_tpu_torch.ops import agc, ffill
from ka9q_sdr_tpu_torch.parallel import mesh as TM
from ka9q_sdr_tpu_torch.utils import graphs

# the package exports a function named dfft beside its module dfft
TDF = importlib.import_module("ka9q_sdr_tpu_torch.parallel.dfft")

FS, LW, M, B = 1.536e6, 30720, 34817, 8
FREQS = list(np.linspace(-0.45 * FS, 0.45 * FS, B, endpoint=False))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def mesh4(card):
    """4 shards: the first 4 cards where the machine has them, else 4
    shards of the card."""
    n = torch.cuda.device_count()
    return TM.make_channel_mesh(devices=[torch.device("cuda", i)
                                         for i in range(4)]
                                if n >= 4 else [card] * 4)


def _blocks(n, seed=3, L=LW, fs=FS, freqs=FREQS[1::2]):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        t = (b * L + np.arange(L)) / fs
        sig = 0.003 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        for j, f in enumerate(freqs):
            ph = 3.0 * np.sin(2 * np.pi * 1000 * t + j)
            env = 1.0 + 0.3 * np.cos(2 * np.pi * 400 * t)
            sig = sig + 0.1 * env * np.exp(1j * (2 * np.pi * (f + 31.0) * t
                                                 + ph))
        x = np.empty((L, 2), np.int16)
        x[:, 0] = np.clip(sig.real * 32767, -32768, 32767)
        x[:, 1] = np.clip(sig.imag * 32767, -32768, 32767)
        out.append(x)
    return out


def _bits(t):
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bit_equal(a, b):
    la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


EDITS = {3: lambda w: w.tune(1, FREQS[1] + 1500.0),
         5: lambda w: w.set_doppler(5, 40.0, 200.0),
         7: lambda w: w.set_filter(-5000.0, 5000.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["FM", "CAM", "USB", "ISB"])
def test_bank_replay_equals_eager(card, mode):
    cfg = TB.make_bank_config(B, mode, samprate=FS, L=LW, M=M,
                              enable_pl=True)
    cap = TB.ChannelBank(cfg, FREQS, device=card)
    eager = TB.ChannelBank(cfg, FREQS, device=card, capture=False)
    blocks = _blocks(12)
    held = []
    for b, x in enumerate(blocks[:10]):
        if b in EDITS:
            EDITS[b](cap)
            EDITS[b](eager)
        f0, a0, r0 = ffill.launches, agc.launches, cap.graphs[0].replays
        got = (cap.process_i16_pcm(x) if b % 3 else
               cap.process_active(x, max_active=4))
        assert cap.graphs[0].replays == r0 + 1
        assert ffill.launches - f0 == (2 if mode == "FM" else 0)
        assert agc.launches - a0 == (0 if mode == "FM" else 1)
        want = (eager.process_i16_pcm(x) if b % 3 else
                eager.process_active(x, max_active=4))
        assert_bit_equal(got, want)
        assert_bit_equal(cap.state, eager.state)
        held.append((got, graphs.clone_tree(got)))
    xs = np.stack(blocks[10:])
    r0 = cap.graphs[0].replays
    got = cap.process_scan_i16(xs, pcm_out=True)
    assert cap.graphs[0].replays == r0 + 1
    want = torch.stack([eager.process_i16_pcm(x)[0] for x in xs])
    assert torch.equal(got, want)
    assert_bit_equal(cap.state, eager.state)
    torch.cuda.synchronize()
    for out, copy in held:              # every earlier block's outputs
        assert_bit_equal(out, copy)


@pytest.mark.cuda
def test_multibank_replay_equals_eager(card):
    groups = [("FM", FREQS[:3]), ("USB", FREQS[3:6]), ("CAM", FREQS[6:])]
    cap = TB.MultiBank(groups, samprate=FS, L=LW, M=M, device=card)
    eager = TB.MultiBank(groups, samprate=FS, L=LW, M=M, device=card,
                         capture=False)
    for b, x in enumerate(_blocks(8)):
        if b == 2:
            for mb in (cap, eager):
                mb.init_channel(2, 1, FREQS[7] + 100.0)
        if b == 4:
            for mb in (cap, eager):
                mb.set_filter(0, -5000.0, 5000.0)
        f0, a0 = ffill.launches, agc.launches
        got = cap.process_i16_pcm(x)
        assert (ffill.launches - f0, agc.launches - a0) == (2, 2)
        assert_bit_equal(got, eager.process_i16_pcm(x))
        assert_bit_equal(cap.states, eager.states)
    assert all(s.overlap is cap.states[0].overlap for s in cap.states)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["FM", "USB", "CAM"])
def test_receiver_replay_equals_eager(card, mode):
    cfg = TR.make_receiver_config(mode, samprate=192000)
    cap = TR.Receiver(cfg, device=card)
    eager = TR.Receiver(cfg, device=card, capture=False)
    for rx in (cap, eager):
        rx.set_freq(30000.0)
    blocks = _blocks(10, L=3840, fs=192000.0, freqs=(30000.0,))
    for b, x in enumerate(blocks[:6]):
        iq = TB.iq_from_i16(torch.as_tensor(x, device=card))
        if b == 2:
            for rx in (cap, eager):
                rx.set_second_lo(-30200.0)
                rx.set_doppler(50.0, 0.0)
        if b == 4:
            for rx in (cap, eager):
                rx.set_filter(low=-4000.0, high=4000.0)
        r0 = cap.graphs[0].replays
        got = cap.process(iq)
        assert cap.graphs[0].replays == r0 + 1
        assert_bit_equal(got, eager.process(iq))
        assert_bit_equal(cap.state, eager.state)
    xs = np.stack(blocks[6:])
    r0 = cap.graphs[0].replays
    got = cap.process_offline(xs)
    assert cap.graphs[0].replays == r0 + 1
    assert torch.equal(_bits(got), _bits(eager.process_offline(xs)))
    assert_bit_equal(cap.state, eager.state)
    cap.set_mode("AM")                  # a new demod state: captured again
    eager.set_mode("AM")
    assert cap.graphs[0].graphs == {}
    x = TB.iq_from_i16(torch.as_tensor(blocks[0], device=card))
    assert_bit_equal(cap.process(x), eager.process(x))


@pytest.mark.cuda
def test_mesh_replay_equals_eager(card):
    """Two shards of the card: one graph a shard, replayed once a block,
    equal to the eager sharded step."""
    cfg = TB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M,
                              enable_pl=True)
    mesh = TM.make_channel_mesh(devices=[card, card])
    cap = TB.ChannelBank(cfg, FREQS, mesh=mesh)
    eager = TB.ChannelBank(cfg, FREQS, mesh=mesh, capture=False)
    for b, x in enumerate(_blocks(6)):
        if b in EDITS:
            EDITS[b](cap)
            EDITS[b](eager)
        f0 = ffill.launches
        got = cap.process_active(x, max_active=4, n_valid=7)
        assert ffill.launches - f0 == 4
        assert_bit_equal(got, eager.process_active(x, max_active=4,
                                                   n_valid=7))
        assert_bit_equal(cap.state, eager.state)
    assert [g.replays for g in cap.graphs] == [6, 6]


@pytest.mark.cuda
def test_capture_holds_off_the_collector(card):
    """The cyclic collector may free a dropped wrapper's graphs at any
    allocation; inside a capture that teardown is forbidden and would
    invalidate the capture, so a capture runs with the collector off (the
    warm-up and what follows with it on)."""
    seen = []

    def step(s, x):
        seen.append(gc.isenabled())
        return (s[0] + x,), (s[0] * 2,)

    g = graphs.StepGraphs(card)
    state = (torch.zeros(4, device=card),)
    out = g.run("k", step, state, (torch.ones(4, device=card),))
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(out[0], torch.zeros(4, device=card))  # from state 0
    assert torch.equal(state[0], torch.ones(4, device=card))
    out = g.run("k", step, state, (torch.ones(4, device=card),))
    assert seen == [True, False] and g.replays == 2
    assert torch.equal(out[0], torch.full((4,), 2.0, device=card))
    assert torch.equal(state[0], torch.full((4,), 2.0, device=card))


@pytest.mark.cuda
def test_cond_node_runs_the_branch_the_device_picks(card):
    """``graphs.cond`` in a captured step: one IF node that the device
    resolves on each replay; the warm-up runs both branches, the capture
    each once, a replay neither (no Python runs)."""
    ran = {"true": 0, "false": 0}

    def bump(c):
        ran["true"] += 1
        return c + 1.0, c * 2.0

    def keep(c):
        ran["false"] += 1
        return c, torch.zeros_like(c)

    def step(s, x):
        n, twice = graphs.cond(x.sum() > 0, bump, keep, s[0])
        return (n,), (twice,)

    cap, eager = graphs.StepGraphs(card), graphs.StepGraphs(card, False)
    s_c = (torch.zeros(3, device=card),)
    s_e = (torch.zeros(3, device=card),)
    signs = [1, -1, -1, 1, 1, -1, 1]
    for sign in signs:
        x = torch.full((4,), float(sign), device=card)
        assert_bit_equal(cap.run("k", step, s_c, (x,)),
                         eager.run("k", step, s_e, (x,)))
        assert_bit_equal(s_c, s_e)
    assert s_c[0].tolist() == [4.0] * 3 and cap.replays == len(signs)
    # eager: one branch a call; the capture: warm-up both, capture both
    # (the false branch makes the outputs' buffers), then replays only
    assert ran == {"true": 2 + signs.count(1), "false": 2 + signs.count(-1)}


@pytest.mark.cuda
def test_cond_node_refuses_a_hand_kernel(card):
    """A kernel counted inside an IF body would be counted on every
    replay, taken or not: the capture raises."""
    def step(s, x):
        filled = graphs.cond(
            x.any(), lambda v: ffill.forward_fill(v, x, s[0][..., 0]),
            lambda v: v, s[0])
        return s, (filled,)

    g = graphs.StepGraphs(card)
    state = (torch.zeros((2, 8), device=card),)
    with pytest.raises(RuntimeError, match="conditional node"):
        g.run("k", step, state, (torch.ones((2, 8), dtype=torch.bool,
                                            device=card),))


@pytest.mark.cuda
def test_gated_scan_equals_single_replays(card):
    """40 FM+PL blocks (the PL measurement fires at blocks 17 and 35) as
    one captured scan (40 IF nodes), as 40 single replays and through the
    eager twin: bit-equal, PCM and state."""
    cfg = TB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M,
                              enable_pl=True)
    scan = TB.ChannelBank(cfg, FREQS, device=card)
    single = TB.ChannelBank(cfg, FREQS, device=card)
    eager = TB.ChannelBank(cfg, FREQS, device=card, capture=False)
    xs = np.stack(_blocks(40))
    got = scan.process_scan_i16(xs, pcm_out=True)
    one = torch.stack([single.process_i16_pcm(x)[0] for x in xs])
    twin = torch.stack([eager.process_i16_pcm(x)[0] for x in xs])
    assert torch.equal(got, one) and torch.equal(got, twin)
    assert_bit_equal(scan.state, single.state)
    assert_bit_equal(scan.state, eager.state)
    assert scan.graphs[0].replays == 1 and single.graphs[0].replays == 40
    # fired at blocks 17 and 35: four blocks' PL samples since
    assert scan.state.demod.pl_counter.tolist() == [4 * 30] * B


@pytest.mark.cuda
def test_gated_multibank_through_init_channel(card):
    """A MultiBank's FM+PL and CAM groups over 40 blocks, an FM row
    re-commissioned at block 9 (its PL counter then runs out of step):
    captured equal to eager bit for bit, the first search included."""
    groups = [("FM", FREQS[:4]), ("CAM", FREQS[4:])]
    kw = dict(samprate=FS, L=LW, M=M, enable_pl=True)
    cap = TB.MultiBank(groups, device=card, **kw)
    eager = TB.MultiBank(groups, device=card, capture=False, **kw)
    for b, x in enumerate(_blocks(40)):
        if b == 9:
            for mb in (cap, eager):
                mb.init_channel(0, 1, FREQS[1])
        assert_bit_equal(cap.process_i16_pcm(x), eager.process_i16_pcm(x))
        assert_bit_equal(cap.states, eager.states)
    fm, cam = (s.demod for s in cap.states)
    assert fm.pl_counter.tolist() == [120, 390, 120, 120]
    assert (cam.fft_samples == 150).all()


def _due(bank, v):
    """Set every shard's PL counter so the next block is due (v > 0) or
    not (v = 0)."""
    for st in bank._state:
        st.demod.pl_counter.fill_(v)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["FM", "CAM", "ISB"])
def test_shard_fft_chain_equals_eager(mesh4, mode):
    """The distributed-master-FFT bank on 4 shards: a chain of three
    graphs a shard, replayed in turn each block, equal to the eager twin
    bit for bit through the live edits (the filter swap recaptures the
    chain) and a due PL block; its scan and its process_active replay one
    graph a shard (the replicated master FFT, as JAX compiles them), equal
    to the twin's; what a call returned survives the replays that
    follow."""
    cfg = TB.make_bank_config(B, mode, samprate=FS, L=LW, M=M,
                              enable_pl=True)
    cap = TB.ChannelBank(cfg, FREQS, mesh=mesh4, shard_fft=True)
    eager = TB.ChannelBank(cfg, FREQS, mesh=mesh4, shard_fft=True,
                           capture=False)
    k = cfg.L_dec // demod_fm.PL_DECIMATE
    blocks = _blocks(12)
    current = torch.cuda.current_device()
    held = []
    for b, x in enumerate(blocks[:10]):
        if b in EDITS:
            EDITS[b](cap)
            EDITS[b](eager)
        if b == 4 and mode == "FM":
            for w in (cap, eager):
                _due(w, demod_fm.PL_FFT_INTERVAL - k)
        f0, a0, r0 = ffill.launches, agc.launches, [
            g.replays for g in cap.graphs]
        got = (cap.process_i16_pcm(x) if b % 3 else
               cap.process_active(x, max_active=4, n_valid=7))
        assert [g.replays for g in cap.graphs] == [
            r + (3 if b % 3 else 1) for r in r0]
        assert ffill.launches - f0 == (8 if mode == "FM" else 0)
        assert agc.launches - a0 == (0 if mode == "FM" else 4)
        want = (eager.process_i16_pcm(x) if b % 3 else
                eager.process_active(x, max_active=4, n_valid=7))
        assert_bit_equal(got, want)
        assert_bit_equal(cap.state, eager.state)
        held.append((got, graphs.clone_tree(got)))
    if mode == "FM":           # the due block fired on every shard
        assert all((st.demod.pl_counter == 5 * k).all()
                   for st in cap.state)
    xs = np.stack(blocks[10:])
    r0 = [g.replays for g in cap.graphs]
    got = cap.process_scan_i16(xs, pcm_out=True)
    assert [g.replays for g in cap.graphs] == [r + 1 for r in r0]
    assert torch.equal(got, eager.process_scan_i16(xs, pcm_out=True))
    assert_bit_equal(cap.state, eager.state)
    x = blocks[0]
    assert_bit_equal(cap.process_i16(x), eager.process_i16(x))
    # the chain's peer access and captures leave the caller's card current
    assert torch.cuda.current_device() == current
    torch.cuda.synchronize()
    for out, copy in held:
        assert_bit_equal(out, copy)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["FM", "CAM"])
def test_shard_fft_active_equals_replicated(mesh4, mode):
    """process_active on a shard_fft bank, between its chain's blocks:
    from the same state, bit-equal to the replicated mesh bank's (PCM,
    indices, diag and state), one replay a shard."""
    cfg = TB.make_bank_config(B, mode, samprate=FS, L=LW, M=M,
                              enable_pl=True)
    sf = TB.ChannelBank(cfg, FREQS, mesh=mesh4, shard_fft=True)
    rep = TB.ChannelBank(cfg, FREQS, mesh=mesh4)
    blocks = _blocks(12, seed=5)
    for b in range(6):
        sf.process_i16_pcm(blocks[2 * b])          # the chain
        rep.state = sf.state
        r0 = [g.replays for g in sf.graphs]
        got = sf.process_active(blocks[2 * b + 1], max_active=4, n_valid=7)
        assert [g.replays for g in sf.graphs] == [r + 1 for r in r0]
        assert_bit_equal(got, rep.process_active(blocks[2 * b + 1],
                                                 max_active=4, n_valid=7))
        assert_bit_equal(sf.state, rep.state)


@pytest.mark.cuda
def test_shard_fft_step_makes_no_host_sync(mesh4):
    """A captured shard_fft block, due and not due, with every host
    synchronisation an error."""
    cfg = TB.make_bank_config(B, "FM", samprate=FS, L=LW, M=M,
                              enable_pl=True)
    bank = TB.ChannelBank(cfg, FREQS, mesh=mesh4, shard_fft=True)
    x = torch.as_tensor(_blocks(1)[0], device=mesh4.devices[0])
    bank.process_i16_pcm(x)             # the captures
    k = cfg.L_dec // demod_fm.PL_DECIMATE
    for v, after in ((demod_fm.PL_FFT_INTERVAL - k, 0), (0, k)):
        _due(bank, v)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bank.process_i16_pcm(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all((st.demod.pl_counter == after).all()
                   for st in bank.state)


@pytest.mark.cuda
def test_make_dfft_chain_equals_eager(mesh4):
    """make_dfft as a chain of two captured graphs a device, bit-equal to
    the eager chain and to the one-function composition, and the FFT."""
    N = 1 << 16
    cap = TDF.make_dfft(mesh4, N)
    eager = TDF.make_dfft(mesh4, N, capture=False)
    sm = TDF.make_dfft_sm(mesh4, N)
    rng = np.random.default_rng(5)
    for i in range(3):
        x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
            np.complex64)
        got = cap(x)
        assert [g.replays for g in cap.graphs.shards] == [2 * (i + 1)] * 4
        assert_bit_equal(got, eager(x))
        xt = torch.as_tensor(x)
        whole = torch.cat([c.to(mesh4.devices[0]) for c in sm(
            [xt[p * N // 4:(p + 1) * N // 4].to(d)
             for p, d in enumerate(mesh4.devices)])])
        assert_bit_equal(got, whole)
        ref = np.fft.fft(x.astype(np.complex128))
        err = np.abs(TDF.undo_comb(got.cpu().numpy(), 4) - ref).max()
        assert err < 2e-5 * np.abs(ref).max()


@pytest.mark.cuda
def test_copy_node_is_captured(card):
    """graphs._copy_node inside a capture: a memcpy node that copies on
    every replay; fetch leaves a tensor on its own device as it is."""
    def step(s, x):
        out = torch.empty_like(x)
        graphs._copy_node(out, x * 2.0)
        assert graphs.fetch(out, card) is out
        return s, (out,)

    g = graphs.StepGraphs(card)
    for v in (1.0, 3.0):
        (out,) = g.run("k", step, (), (torch.full((64,), v, device=card),))
        assert torch.equal(out, torch.full((64,), 2 * v, device=card))
    assert g.replays == 2
