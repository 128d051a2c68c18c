"""A configuration on a mesh of devices, at a tiny size on CPU shards: the
harness builds the bank as ``bankd --mesh`` does (channels padded to the
mesh, ``n_valid`` the real count, the padding rows dropped from every
output), it serves exactly what one device serves, a whole run of it is
correct and comes out not correct with the timed path broken underneath,
the peak is the fullest card's, each card's device time comes from the
trace, and the one-device configurations build as before."""

import numpy as np
import pytest
import torch

from sdrbench import cells, devtime, generator, program
from sdrbench.run import Run, peak_reserved, run_cell
from sdrbench.tests import tiny

SEED = 2**31 + 4094
MESH = "fm_pl_4094_mesh4_20ms"
CPU = torch.device("cpu")


def _loop(cfg, traffic, seed=SEED):
    groups = program.channel_freqs(cfg)
    plan = generator.draw(groups, float(cfg["samprate"]), traffic["signals"],
                          seed)
    return generator.make_loop(plan, cfg["L"], traffic["noise_rms"], seed,
                               "cpu")


def _host(out: dict) -> dict:
    return {k: v.numpy() for k, v in out.items()}


def _same(a: dict, b: dict) -> None:
    """Two blocks' outputs equal bit for bit (NaN where NaN); a compacted
    block's slots compared by channel, not by slot order."""
    assert a.keys() == b.keys()
    for k in a:
        if k.endswith((".idx", ".pcm")) and any(x.endswith(".idx")
                                                for x in a):
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k], equal_nan=True), k
    for k in (x for x in a if x.endswith(".idx")):
        g = k[:-len(".idx")]
        rows = [{int(c): p.tobytes() for c, p in zip(o[k], o[g + ".pcm"])
                 if c >= 0} for o in (a, b)]
        assert rows[0] == rows[1], k


def test_mesh_configuration_builds_on_four_cpu_shards():
    cfg = tiny.config(MESH)
    assert program.mesh_size(cfg) == 4 and cfg["shard_fft"]
    s = program.System(cfg, True, CPU)
    assert s.mesh.size == 4
    assert s.n_real == 62
    assert len(s.bank.freqs) == 64 and s.bank.cfg.n_channels == 64
    # the padding repeats the last real frequency, as bankd pads
    assert s.bank.freqs[62:] == [s.bank.freqs[61]] * 2
    assert s.bank.shard_fft
    # a mesh built once by the caller is the one the bank runs on
    mesh = program.make_mesh(cfg, CPU)
    assert mesh.devices == (CPU,) * 4
    assert program.System(cfg, True, CPU, mesh=mesh).mesh is mesh


def test_mesh_serves_what_one_device_serves_bit_for_bit():
    cfg = tiny.config(MESH)
    loop = _loop(cfg, tiny.traffic("live"))
    mesh = program.System(cfg, True, CPU)
    one = program.System(dict(cfg, mesh=1), True, CPU)
    assert one.mesh is None and one.n_real is None
    for b in range(6):
        a, o = _host(mesh.call(loop[b])), _host(one.call(loop[b]))
        _same(a, o)
        assert a["g0.idx"].max() < 62
        for k in ("snr", "bb_power", "squelch_open", "plfreq"):
            assert a[f"g0.{k}"].shape == (62,), k
    # a fresh state written back serves block 0 again as it did
    mesh.reset()
    one.reset()
    _same(_host(mesh.call(loop[0])), _host(one.call(loop[0])))


def test_a_multibank_on_a_mesh_is_refused():
    cfg = dict(tiny.config("mixed6144_20ms"), mesh=4)
    with pytest.raises(ValueError, match="mesh"):
        program.System(cfg, False, CPU)


def test_one_card_configurations_build_as_before():
    for name in ("fm_pl_4096_20ms", "mixed6144_20ms"):
        cfg = tiny.config(name)
        assert program.mesh_size(cfg) == 1
        assert program.make_mesh(cfg, CPU) is None
        s = program.System(cfg, True, CPU)
        assert s.mesh is None and s.n_real is None
        assert s.bank.device == CPU
    # the one-card compaction calls the entry as before: no n_valid
    s = program.System(tiny.config("fm_pl_4096_20ms"), True, CPU)
    seen = []
    entry = s.bank.process_active

    def spy(*args, **kwargs):
        seen.append((args[1:], kwargs))
        return entry(*args, **kwargs)

    s.bank.process_active = spy
    cfg = tiny.config("fm_pl_4096_20ms")
    out = s.call(_loop(cfg, tiny.traffic("live"))[0])
    assert seen == [((8,), {})]
    assert out["g0.bb_power"].shape == (64,)


def test_peak_reader_takes_the_fullest_card():
    read = {"c0": 5 << 30, "c1": 7 << 30, "c2": 6 << 30, "c3": 1 << 30}.get
    assert peak_reserved(["c0", "c1", "c2", "c3"], read) == (
        7 << 30, [5 << 30, 7 << 30, 6 << 30, 1 << 30])
    assert peak_reserved(["c0"], read) == (5 << 30, [5 << 30])
    run = Run({"groups": [["FM", 4]], "L": 1}, "cpu", 1.0, "open", 0.02)
    run.peak_reserved = 7 << 30
    assert cells.reader("peak_reserved_gib")(run) == 7.0


def test_trace_reduction_keeps_card_zero_and_names_the_others():
    ev = [{"cat": "cpu_op", "name": "h", "ts": 0, "dur": 100},
          {"cat": "kernel", "name": "k", "ts": 10, "dur": 20,
           "args": {"device": 0}},
          {"cat": "kernel", "name": "k", "ts": 10, "dur": 60,
           "args": {"device": 2}},
          {"cat": "gpu_memcpy", "name": "Memcpy PtoP", "ts": 40, "dur": 10,
           "args": {"device": 1}},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 10}]
    r = devtime.reduce_events(ev)
    assert r["busy_s"] == pytest.approx(30e-6)      # card 0's alone
    ops = dict(r["device_ops"])
    assert ops == pytest.approx({"k": 20e-6, "cuda2:k": 60e-6,
                                 "cuda1:Memcpy PtoP": 10e-6,
                                 "Memcpy HtoD": 10e-6})
    assert r["card_busy_s"] == pytest.approx(
        {0: 30e-6, 1: 10e-6, 2: 60e-6})


def test_card_device_time_is_the_busiest_cards_from_the_trace():
    # two blocks traced: card 0's copy and step, card 1's step twice over
    # overlapping kernels (counted once), card 2 idle but for one copy
    ev = [{"cat": "cpu_op", "name": "h", "ts": 0, "dur": 1000},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 0, "dur": 100},
          {"cat": "kernel", "name": "step", "ts": 100, "dur": 300,
           "args": {"device": 0}},
          {"cat": "kernel", "name": "step", "ts": 100, "dur": 400,
           "args": {"device": 1}},
          {"cat": "kernel", "name": "fft", "ts": 300, "dur": 300,
           "args": {"device": 1}},
          {"cat": "kernel", "name": "step", "ts": 600, "dur": 400,
           "args": {"device": 1}},
          {"cat": "gpu_memcpy", "name": "Memcpy PtoP", "ts": 50, "dur": 40,
           "args": {"device": 2}}]
    run = Run({"groups": [["FM", 4]], "L": 1}, "cpu", 0.1, "open", 0.02)
    read = cells.reader("card_device_ms.live")
    assert read(run) is None                    # untraced
    run.trace = devtime.reduce_events(ev)
    run.traced_blocks = 2
    # card 1: 100-600 and 600-1000 us, 900 us over 2 blocks
    assert read(run) == pytest.approx(0.45)
    # one card in the trace: nothing to read
    run.trace = devtime.reduce_events(ev[:3])
    assert read(run) is None
    closed = Run({"groups": [["FM", 4]], "L": 1}, "cpu", 0.1, "closed",
                 0.02)
    closed.trace, closed.traced_blocks = devtime.reduce_events(ev), 2
    assert read(closed) is None


class _Frozen(program.System):
    """Every block from the fresh state: the step's new state dropped."""

    def call(self, x):
        out = super().call(x)
        self.reset()
        return out


class _Half(program.System):
    """Every other channel's diag and every other slot's PCM left out."""

    def call(self, x):
        out = super().call(x)
        for k, v in out.items():
            if k.endswith((".pcm", ".bb_power")):
                v[::2] = 0
        return out


class _Altered(program.System):
    """One instant of one block's PCM changed by 64 LSB in every slot."""

    n = 0

    def call(self, x):
        out = super().call(x)
        _Altered.n += 1
        if _Altered.n == 5:                 # block 2 (two warm-up calls)
            out["g0.pcm"][:, 100] += 64
        return out


class _NoFanOut(program.System):
    """The block never reaches the shards past the first: they demodulate
    silence (the exchange between devices left out)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        sb = self.bank._sharded

        def run(states, x, ingest, pcm_out, replicated=False):
            x = torch.as_tensor(x, device=sb.mesh.devices[0])
            xs = [x] + [torch.zeros_like(x) for _ in sb.mesh.devices[1:]]
            return [g.run((ingest, pcm_out), sb._shard_fn(d, ingest, pcm_out),
                          states[d], (xs[d],))
                    for d, g in enumerate(sb.graphs)]

        sb._run = run


class _Dropped(program.System):
    """The compaction's first active channel reported as unused."""

    def call(self, x):
        out = super().call(x)
        idx = out["g0.idx"]
        idx[int(np.argmax(idx.numpy() >= 0))] = -1
        return out


def _run(factory=None, seconds=2.0):
    _Altered.n = 0
    return run_cell(tiny.config(MESH), tiny.traffic("live"),
                    cells.limits("fm4094-mesh4-live"), SEED, seconds, False,
                    CPU, system_factory=factory)


def test_sound_mesh_run_is_correct():
    res = _run(seconds=4.0)
    assert res["attempted"] >= 4
    assert res["correct"], res["checks"]
    assert res["rec"].traced_blocks == 0     # untraced


@pytest.mark.parametrize("fault", [_Frozen, _Half, _Altered, _NoFanOut,
                                   _Dropped])
def test_broken_mesh_path_is_not_correct(fault):
    res = _run(fault, 4.0 if fault is _Dropped else 2.0)
    assert not res["correct"], res["checks"]
