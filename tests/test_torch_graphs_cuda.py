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
"""

import gc

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.models import receiver as TR
from ka9q_sdr_tpu_torch.ops import agc, ffill
from ka9q_sdr_tpu_torch.parallel import mesh as TM
from ka9q_sdr_tpu_torch.utils import graphs

FS, LW, M, B = 1.536e6, 30720, 34817, 8
FREQS = list(np.linspace(-0.45 * FS, 0.45 * FS, B, endpoint=False))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
