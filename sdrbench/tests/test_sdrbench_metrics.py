"""The metric arithmetic on synthetic timestamps: ch_msps over the window,
the p95 from due times (one injected stall moves it), idle from the
trace's device intervals, the fill and AGC byte counts from shapes, and
the readers as BENCHMARK.json finds them."""

import pytest

from sdrbench import cells, devtime, yardstick
from sdrbench.run import Run
from sdrbench.serve import Block


def test_ch_msps_counts_blocks_done_within_the_window():
    done_ms = [10.0 * (i + 1) for i in range(120)]          # 10 ms a block
    n = yardstick.blocks_within(done_ms, 1.0)
    assert n == 100
    assert yardstick.ch_msps(4096, 7864320, n, 1.0) == pytest.approx(
        4096 * 7864320 * 100 / 1e6)


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert yardstick.percentile(v, 95) == 95
    assert yardstick.percentile(v, 50) == 50
    assert yardstick.percentile([], 95) is None


def _open_run(stall_at=None, n=200, period=0.02, work=0.008):
    blocks, t = [], 0.0
    for i in range(n):
        due = (i + 1) * period
        start = max(due, t)
        t = start + work + (0.5 if i == stall_at else 0.0)
        blocks.append(Block(i, due=due, call=start, ret=start + work / 2,
                            done=t))
    run = Run({"groups": [["FM", 4096]], "L": 7864320}, "cpu", n * period,
              "open", period)
    run.blocks = blocks
    return run


def test_p95_from_due_times_moves_with_one_stall():
    calm, stalled = _open_run(), _open_run(stall_at=100)
    read = cells.reader("block_p95_ms")
    assert read(calm) == pytest.approx(8.0)
    # the 0.5 s stall delays the blocks queued behind it, each timed from
    # its own due time, until the 12 ms of slack a block has cleared it:
    # 41 of 200 blocks late, past the 95th percentile
    assert read(stalled) > 100.0
    assert cells.reader("start_late_ms.live")(stalled) > 100.0
    assert cells.reader("start_late_ms.live")(calm) == pytest.approx(0.0)
    late = yardstick.late_blocks([b.done for b in stalled.blocks],
                                 [b.due for b in stalled.blocks], 0.02)
    assert late == 41
    assert yardstick.late_blocks([b.done for b in calm.blocks],
                                 [b.due for b in calm.blocks], 0.02) == 0


def test_idle_from_intervals():
    # device activity in us as the profiler exports it: two overlapping
    # kernels, a copy, and host spans from 0 to 100 us
    dev = [(0.0, 4.0, "kernel"), (10.0, 14.0, "kernel"),
           (12.0, 16.0, "gpu_memcpy"), (95.0, 100.0, "kernel")]
    events = [{"cat": c, "ts": a, "dur": b - a, "name": c}
              for a, b, c in dev]
    events += [{"cat": "user_annotation", "ts": 0.0, "dur": 50.0,
                "name": "sdrbench.call"},
               {"cat": "cpu_op", "ts": 50.0, "dur": 50.0, "name": "op"}]
    assert yardstick.merged([(a, b) for a, b, _ in dev]) == [
        [0.0, 4.0], [10.0, 16.0], [95.0, 100.0]]
    t = devtime.reduce_events(events)
    assert t["busy_s"] == pytest.approx(15e-6)
    assert t["window_s"] == pytest.approx(100e-6)
    assert dict(t["idle_gaps"]) == pytest.approx(
        {"sdrbench.call": 6e-6, "sdrbench.between_blocks": 79e-6})
    run = Run({"groups": [["FM", 8]], "L": 100}, "cpu", 0.1, "closed",
              0.02)
    assert cells.reader("device_idle_pct.sat")(run) is None   # untraced
    run.trace = t
    assert cells.reader("device_idle_pct.sat")(run) == pytest.approx(85.0)
    assert cells.reader("device_idle_pct.sat")(_open_run()) is None


def test_byte_counts_from_shapes():
    # complex64 values + mask + complex64 out, float32 likewise, inits
    assert yardstick.fill_bytes(4096, 960) == (
        4096 * 960 * 17 + 4096 * 8 + 4096 * 960 * 9 + 4096 * 4)
    assert yardstick.agc_bytes(512, 960, calls=2) == 2 * (
        512 * 960 * 8 + 512 * 16)
    # 102 MB over 3.35 TB/s is 0.0305 ms: at 0.0519 ms cold that is 59%
    share = yardstick.roofline_pct(yardstick.fill_bytes(4096, 960),
                                   0.0519e-3, "NVIDIA H100 80GB HBM3")
    assert share == pytest.approx(58.7, abs=0.2)
    assert yardstick.roofline_pct(1, 1.0, "cpu") is None


def test_every_metric_benchmark_names_has_a_reader():
    bench = cells.benchmark(cells.HERE.parent)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    closed = Run({"groups": [["FM", 8]], "L": 100}, "cpu", 1.0,
                 "closed", 0.02)
    closed.dev_ms = [(0.0, 1.0, 2.0)] * 10
    closed.blocks = [Block(i, call=0.0, ret=0.001) for i in range(10)]
    assert cells.reader("ch_msps")(closed) == pytest.approx(8 * 100 * 10
                                                            / 1e6)
    assert cells.reader("block_p95_ms")(closed) is None
    assert cells.reader("ffill_roofline")(closed) is None
