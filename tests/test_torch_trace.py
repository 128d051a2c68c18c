"""The port's tracer (``utils/trace.py``) on the CPU: the block recorder
that is always on, the stage marks, the spans under ``torch.profiler``, the
harvest that never waits, the capture records and bankd's split read from
the recorder.

Tiny eager banks at 192 kHz (L 3840, M 4353, N 8192, 960 output samples a
block): a 2-channel FM+PL ``ChannelBank`` and a ``MultiBank`` of FM:1 +
USB:2 + CAM:1.  On the CPU the stage marks are host stamps; the card's
marks (event-record nodes of the captured graph) are held against the
replay's own events in ``tests/test_torch_graphs_cuda.py``.
"""

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ka9q_sdr_tpu_torch.apps import bankd
from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.utils import trace

FS, L, M = 192000.0, 3840, 4353
C = {c: i for i, c in enumerate(trace.COLUMNS)}


def _channel_bank():
    cfg = TB.make_bank_config(2, "FM", samprate=FS, L=L, M=M, enable_pl=True)
    return TB.ChannelBank(cfg, [-30e3, 40e3], device="cpu")


def _multi_bank():
    return TB.MultiBank([("FM", [-30e3]), ("USB", [10e3, 30e3]),
                         ("CAM", [0.0])], samprate=FS, L=L, M=M,
                        device="cpu")


def _block(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-900, 900, (L, 2), dtype=np.int16)


#: (wrapper, entry, its variant, call)
ENTRIES = {
    "bank.i16_pcm": (_channel_bank, "ChannelBank.process_i16_pcm",
                     lambda w, x: w.process_i16_pcm(x)),
    "bank.i16": (_channel_bank, "ChannelBank.process_i16",
                 lambda w, x: w.process_i16(x)),
    "bank.active": (_channel_bank, "ChannelBank.process_active",
                    lambda w, x: w.process_active(x, 1)),
    "bank.complex": (_channel_bank, "ChannelBank.process",
                     lambda w, x: w.process(
                         (x[:, 0] + 1j * x[:, 1]).astype(np.complex64))),
    "bank.scan": (_channel_bank, "ChannelBank.process_scan_i16",
                  lambda w, x: w.process_scan_i16(np.stack([x, x]))),
    "multi.i16_pcm": (_multi_bank, "MultiBank.process_i16_pcm",
                      lambda w, x: w.process_i16_pcm(x)),
    "multi.i16": (_multi_bank, "MultiBank.process_i16",
                  lambda w, x: w.process_i16(x)),
    "multi.complex": (_multi_bank, "MultiBank.process",
                      lambda w, x: w.process(x.astype(np.float32))),
    "bank.packed": (_channel_bank, "ChannelBank.process",
                    lambda w, x: w.process(x.astype(np.float32))),
}


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_rows_in_order_inside_the_callers_interval(name):
    make, variant, call = ENTRIES[name]
    w, x = make(), _block()
    spans = []
    for _ in range(3):
        a = time.perf_counter_ns()
        call(w, x)
        spans.append((a, time.perf_counter_ns()))
    rows = trace.rows()
    assert rows.shape == (3, len(trace.COLUMNS))
    assert list(rows[:, C["seq"]]) == sorted(rows[:, C["seq"]])
    names = trace.variant_names()
    for r, (a, b) in zip(rows, spans):
        assert names[r[C["variant"]]] == variant
        # the caller's interval holds the row; the stamps come in order
        assert a <= r[C["start"]] <= r[C["put"]] <= r[C["launch"]] \
            <= r[C["end"]] <= b
        assert r[C["stagein"]] == 0           # eager: no static input
    put, launch = trace.last_split()
    last = rows[-1]
    assert put == pytest.approx((last[C["put"]] - last[C["start"]]) * 1e-9)
    assert launch == pytest.approx((last[C["end"]] - last[C["put"]]) * 1e-9)


def test_ring_wraps():
    noop = trace.entry("test.noop")(lambda: None)
    extra = 37
    for _ in range(trace.RING + extra):
        noop()
    rows = trace.rows()
    assert rows.shape[0] == trace.RING
    seqs = rows[:, C["seq"]]
    assert seqs[0] == extra and seqs[-1] == trace.RING + extra - 1
    assert (np.diff(seqs) == 1).all()
    assert (rows[:, C["end"]] >= rows[:, C["start"]]).all()
    assert (np.diff(rows[:, C["start"]]) >= 0).all()


def test_a_call_inside_an_entry_is_part_of_it():
    inner = trace.entry("test.inner")(lambda: None)
    outer = trace.entry("test.outer")(lambda: inner())
    outer()
    rows = trace.rows()
    assert rows.shape[0] == 1
    assert trace.variant_names()[rows[0, C["variant"]]] == "test.outer"


def test_recorder_allocates_nothing_with_the_profiler_off():
    bank, x = _channel_bank(), _block()
    bank.process_i16_pcm(x)
    tracemalloc.start()
    try:
        # what a call keeps until the next replaces it (the last row's
        # offset, past Python's cached small ints) is traced from here on
        for _ in range(40):
            bank.process_i16_pcm(x)
        before = tracemalloc.take_snapshot()
        for _ in range(200):
            bank.process_i16_pcm(x)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, trace.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno") if d.size_diff > 0]
    assert grown == []
    assert trace.stages() == []               # nothing detailed was kept
    assert trace.rows().shape[0] == 241


def test_rows_of_daemons_on_threads():
    banks = [_channel_bank() for _ in range(3)]
    x = _block()
    spans = {}

    def serve(i):
        got = spans.setdefault(threading.get_ident(), [])
        for _ in range(6):
            a = time.perf_counter_ns()
            banks[i].process_i16_pcm(x)
            got.append((a, time.perf_counter_ns()))

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = trace.rows()
    assert rows.shape[0] == 18
    assert len(set(rows[:, C["seq"]])) == 18
    _each_call_has_its_row(rows, spans)
    assert (rows[:, C["start"]] <= rows[:, C["put"]]).all()
    assert (rows[:, C["put"]] <= rows[:, C["end"]]).all()


def _each_call_has_its_row(rows, spans):
    """Every caller's interval holds a row, and every row lies inside a
    caller's interval of as many calls as rows."""
    calls = [ab for got in spans.values() for ab in got]
    assert len(calls) == rows.shape[0]
    s, e = rows[:, C["start"]], rows[:, C["end"]]
    for a, b in calls:
        assert ((a <= s) & (e <= b)).any()
    for si, ei in zip(s, e):
        assert any(a <= si and ei <= b for a, b in calls)


def test_rows_stay_whole_under_thread_switches():
    """More threads than cores, switching every microsecond: no two calls
    share a row, and each thread's rows come in its own order, each inside
    its caller's interval."""
    import os
    import sys

    n_threads, n_calls = 4 * (os.cpu_count() or 2), 300
    noops, vids, spans = [], [], {}
    for k in range(n_threads):
        vids.append(len(trace.variant_names()))
        noops.append(trace.entry(f"test.noop{k}")(lambda: None))

    def work(k):
        got = spans.setdefault(k, [])
        for _ in range(n_calls):
            a = time.perf_counter_ns()
            noops[k]()
            got.append((a, time.perf_counter_ns()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    rows = trace.rows()
    assert rows.shape[0] == n_threads * n_calls
    assert len(set(rows[:, C["seq"]])) == rows.shape[0]
    assert (rows[:, C["start"]] <= rows[:, C["end"]]).all()
    # each thread's own entry: its rows are its calls, in its order
    for k, got in spans.items():
        mine = rows[rows[:, C["variant"]] == vids[k]]
        assert len(mine) == len(got) == n_calls
        for r, (a, b) in zip(mine, got):
            assert a <= r[C["start"]] <= r[C["end"]] <= b


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_spans_under_the_profiler(tmp_path):
    bank, mb, x = _channel_bank(), _multi_bank(), _block()
    bank.process_i16_pcm(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bank.process_i16_pcm(x)
        mb.process_i16_pcm(x)
    names = [e["name"] for e in _trace_events(prof, tmp_path)
             if str(e.get("name", "")).startswith("ka9q.")]
    assert {"ka9q.put", "ka9q.replay", "ka9q.clone"} <= set(names)
    assert names.count("ka9q.put") == 2
    # off again: nothing detailed is kept for later calls
    n = len(trace.stages())
    bank.process_i16_pcm(x)
    assert len(trace.stages()) == n == 2


def _stage_names(make, call):
    trace.reset()
    w, x = make(), _block()
    call(w, x)
    with profile(activities=[ProfilerActivity.CPU]):
        call(w, x)
    (seq, variant, ms), = trace.stages()
    assert all(v >= 0.0 for v in ms.values())
    return variant, list(ms)


def test_stage_names_come_in_order_with_their_groups():
    variant, names = _stage_names(_channel_bank,
                                  lambda w, x: w.process_i16_pcm(x))
    assert variant == "ChannelBank.process_i16_pcm"
    assert names == ["upload", "ingest", "fft", "g0.channelize", "g0.demod",
                     "g0.pack", "clone"]
    variant, names = _stage_names(_multi_bank,
                                  lambda w, x: w.process_i16_pcm(x))
    assert variant == "MultiBank.process_i16_pcm"
    assert names == ["upload", "ingest", "fft",
                     "g0.channelize", "g0.demod", "g1.channelize",
                     "g1.demod", "g2.channelize", "g2.demod",
                     "g0.pack", "g1.pack", "g2.pack", "clone"]


def test_stage_names_of_many_groups():
    """25 single-channel groups (bankd's channel file makes one a mode and
    passband): 3 stages a group beside ingest, fft, upload and clone."""
    modes = ("FM", "USB", "CAM", "LSB", "AM")
    groups = [(modes[i % 5], [-60e3 + 5e3 * i]) for i in range(25)]
    _, names = _stage_names(
        lambda: TB.MultiBank(groups, samprate=FS, L=L, M=M, device="cpu"),
        lambda w, x: w.process_i16_pcm(x))
    assert names == (["upload", "ingest", "fft"]
                     + [f"g{g}.{s}" for g in range(25)
                        for s in ("channelize", "demod")]
                     + [f"g{g}.pack" for g in range(25)] + ["clone"])


def test_compaction_is_pack_and_a_scan_has_no_stages():
    _, names = _stage_names(_channel_bank, lambda w, x: w.process_active(x, 1))
    assert names == ["upload", "ingest", "fft", "g0.channelize", "g0.demod",
                     "g0.pack", "clone"]
    _, names = _stage_names(_channel_bank,
                            lambda w, x: w.process_scan_i16(np.stack([x, x])))
    assert names == ["upload", "clone"]


class _Running:
    """An event of a replay still running: query() says not done until
    `done` is set, and nothing may wait on it or read its time before."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        raise AssertionError("the harvest waited")

    def elapsed_time(self, end):
        if not self.done:
            raise AssertionError("the harvest read a running event")
        return 1.5


def _running_call(seq=99):
    """A pending detailed call whose two events are still running."""
    evs = (_Running(), _Running())
    trace._t.pending.append((seq, 0, [trace._Events(
        [("ingest", evs[0]), ("end", evs[1])])]))
    return evs


def test_harvest_of_a_running_replay_counts_a_miss():
    """A call still running when ``stages()`` reads is one miss (before,
    when every upload drained the stream, a call found running at the
    next call's harvest was one)."""
    bank, x = _channel_bank(), _block()
    with profile(activities=[ProfilerActivity.CPU]):
        bank.process_i16_pcm(x)
    # one completed call pending, then one whose replay is still running
    _running_call()
    bank.process_i16_pcm(x)                # harvests after its upload
    assert trace.stage_missed == 0         # still running: kept pending
    assert [s for s, _, _ in trace.stages()] == [0]   # the profiled call
    assert trace.stage_missed == 1
    assert trace._t.pending == []


def test_harvest_keeps_a_running_call_until_it_completes():
    bank, x = _channel_bank(), _block()
    evs = _running_call()
    bank.process_i16_pcm(x)
    bank.process_i16_pcm(x)
    assert [seq for seq, _, _ in trace._t.pending] == [99]
    assert trace.stage_missed == 0
    for ev in evs:
        ev.done = True
    bank.process_i16_pcm(x)                # its events have completed now
    assert trace._t.pending == []
    (seq, _, ms), = trace.stages()
    assert seq == 99 and ms == {"ingest": 1.5}
    assert trace.stage_missed == 0


def test_harvest_drops_the_oldest_past_its_cap():
    bank, x = _channel_bank(), _block()
    for seq in range(trace.PENDING + 3):
        _running_call(seq)
    bank.process_i16_pcm(x)
    assert trace.stage_missed == 3
    assert [seq for seq, _, _ in trace._t.pending] == list(
        range(3, trace.PENDING + 3))


def test_capture_records_sum_to_capture_s():
    """The tracer keeps each capture's record in order (a captured step
    adds the same seconds to its ``capture_s``: the card's marks case);
    the CPU captures nothing."""
    bank, x = _channel_bank(), _block()
    bank.process_i16_pcm(x)
    assert bank.graphs[0].capture_s == 0.0 and trace.captures() == []
    trace.captured("('i16', True)", 0.25)
    trace.captured("('active', 64, None)", 0.5)
    assert trace.captures() == [("('i16', True)", 0.25),
                                ("('active', 64, None)", 0.5)]
    assert sum(s for _, s in trace.captures()) == pytest.approx(0.75)


def test_bankd_split_is_read_from_the_recorder():
    bank, x = _channel_bank(), _block()
    timing = bankd.Timing()
    for _ in range(4):
        bank.process_i16_pcm(x)
        timing.entry()
        timing.n += 1
    rows = trace.rows()
    put = sum(r[C["put"]] - r[C["start"]] for r in rows) * 1e-9
    launch = sum(r[C["end"]] - r[C["put"]] for r in rows) * 1e-9
    assert timing.t["put"] == pytest.approx(put)
    assert timing.t["launch"] == pytest.approx(launch)
    assert timing.t["step"] == pytest.approx(put + launch)
    line = timing.line()
    fields = dict((k, float(v)) for k, v in
                  (p.split() for p in line.split(":", 1)[1]
                   .split(" ms/blk")[0].split("  ")))
    assert set(fields) == set(bankd.Timing.KEYS) | {"total"}
    assert fields["total"] == pytest.approx(fields["step"], abs=2e-3)
