"""The readers of the program's own records (``sdrbench/recorder.py`` and
the metrics built on it) on synthetic runs and a synthetic recorder:
blocks matched to rows by host time, the slowest 5% by latency, the
stages summed over groups, the captures; a program without a recorder
gives no number; and on a tiny CPU bank served by the harness's loop every
block finds its row."""

import types

import numpy as np
import pytest

from sdrbench import cells, recorder
from sdrbench.run import Run
from sdrbench.serve import Block

COLUMNS = ("start", "put", "stagein", "launch", "end", "seq", "variant")
NS = 1_000_000_000


def _fake(rows=(), stages=(), captures=(), missed=0):
    """A recorder as the program's ``utils.trace`` exposes it."""
    a = np.array(rows, np.int64).reshape(-1, len(COLUMNS))
    return types.SimpleNamespace(COLUMNS=COLUMNS, rows=lambda: a.copy(),
                                 stages=lambda: list(stages),
                                 captures=lambda: list(captures),
                                 stage_missed=missed)


def _row(seq, start, put, end, stagein=None, launch=None):
    """A row from seconds: entry start, upload end, entry end (the
    static-input copy's end and the launch at the upload's end unless
    given)."""
    s, p, e = (int(round(t * NS)) for t in (start, put, end))
    si = p if stagein is None else int(round(stagein * NS))
    la = si if launch is None else int(round(launch * NS))
    return [s, p, si, la, e, seq, 0]


def _run(loop, n=100, slow=(), period=0.02):
    """n blocks, each called at its due time, its entry 2 ms (put 0.5,
    launch 1.5); the `slow` blocks' entry takes 10 ms more in the
    upload."""
    blocks, rows = [], []
    for i in range(n):
        due = 100.0 + (i + 1) * period
        extra = 0.010 if i in slow else 0.0
        call, start = due, due + 1e-5
        put = start + 0.0005 + extra
        end = put + 0.0015
        ret = end + 1e-5
        blocks.append(Block(i, due=due, call=call, ret=ret, done=ret + 0.003))
        rows.append(_row(i + 5, start, put, end))
    # rows of calls outside the window (set-up, the traced span) match none
    rows.append(_row(1, 99.0, 99.001, 99.002))
    rows.append(_row(400, 200.0, 200.001, 200.002))
    run = Run({"groups": [["FM", 8]], "L": 100}, "cpu", n * period, loop,
              period)
    run.blocks = blocks
    return run, rows


def test_match_by_host_time():
    starts = np.array([1.0, 2.0, 3.0, 4.0])
    ends = starts + 0.5
    idx = recorder.match([0.9, 1.95, 3.2, 3.9], [1.6, 2.6, 3.9, 4.4],
                         starts, ends)
    # the third block's interval holds no row's start; the fourth ends
    # before its row does
    assert list(idx) == [0, 1, -1, -1]
    assert list(recorder.match([1.0], [2.0], [], [])) == [-1]


def test_host_split_medians(monkeypatch):
    run, rows = _run("open", slow=(3, 50))
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake(rows))
    s = recorder.split(run)
    assert s["matched"] == 100
    assert np.nanmedian(s["put"]) == pytest.approx(0.5)
    assert np.nanmedian(s["launch"]) == pytest.approx(1.5)
    assert cells.reader("put_host_ms.live")(run) == pytest.approx(0.5)
    assert cells.reader("launch_host_ms.live")(run) == pytest.approx(1.5)
    assert cells.reader("put_host_ms.sat")(run) is None      # open loop
    closed, rows = _run("closed")
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake(rows))
    assert cells.reader("put_host_ms.sat")(closed) == pytest.approx(0.5)
    assert cells.reader("launch_host_ms.sat")(closed) == pytest.approx(1.5)
    assert cells.reader("launch_host_ms.live")(closed) is None


def test_tail_is_the_slowest_five_percent_by_latency(monkeypatch):
    slow = (7, 21, 40, 66, 93)                 # 5 of 100
    run, rows = _run("open", slow=slow)
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake(rows))
    assert sorted(recorder.slowest(run)) == list(slow)
    assert cells.reader("put_tail_ms.live")(run) == pytest.approx(10.5)
    assert cells.reader("launch_tail_ms.live")(run) == pytest.approx(1.5)
    # the whole window's medians stay where the calm blocks are
    assert cells.reader("put_host_ms.live")(run) == pytest.approx(0.5)


def test_a_block_without_a_row_has_no_split(monkeypatch):
    run, rows = _run("open", n=20)
    del rows[4]
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake(rows))
    s = recorder.split(run)
    assert s["matched"] == 19 and np.isnan(s["put"][4])
    assert cells.reader("put_host_ms.live")(run) == pytest.approx(0.5)


STAGES = [
    (10, "MultiBank.process_i16_pcm",
     {"upload": 0.6, "stagein": 0.07, "ingest": 0.4, "fft": 0.3,
      "g0.channelize": 0.5, "g0.demod": 0.8, "g1.channelize": 0.1,
      "g1.demod": 0.2, "g0.pack": 0.05, "g1.pack": 0.15, "clone": 0.1}),
    (11, "MultiBank.process_i16_pcm",
     {"upload": 0.8, "stagein": 0.09, "ingest": 0.4, "fft": 0.3,
      "g0.channelize": 0.7, "g0.demod": 0.8, "g1.channelize": 0.1,
      "g1.demod": 0.4, "g0.pack": 0.05, "g1.pack": 0.25, "clone": 0.1}),
    (12, "MultiBank.process_i16_pcm",
     {"upload": 0.7, "stagein": 0.08, "ingest": 0.5, "fft": 0.3,
      "g0.channelize": 0.6, "g0.demod": 0.9, "g1.channelize": 0.2,
      "g1.demod": 0.3, "g0.pack": 0.05, "g1.pack": 0.05, "clone": 0.3}),
]


def test_stages_summed_over_groups(monkeypatch):
    monkeypatch.setattr(recorder, "program_trace",
                        lambda: _fake(stages=STAGES))
    run, _ = _run("closed", n=3)
    want = {"upload": 0.7, "stagein": 0.08, "clone": 0.1, "ingest": 0.4,
            "fft": 0.3, "channelize": 0.8, "demod": 1.2, "pack": 0.2}
    for stage, v in want.items():
        assert cells.reader(f"{stage}_dev_ms.sat")(run) == pytest.approx(v)
    live, _ = _run("open", n=3)
    assert cells.reader("fft_dev_ms.sat")(live) is None
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake())
    assert cells.reader("fft_dev_ms.sat")(run) is None    # untraced


def test_a_missed_harvest_leaves_the_stages_unread(monkeypatch):
    monkeypatch.setattr(recorder, "program_trace",
                        lambda: _fake(stages=STAGES, missed=1))
    run, _ = _run("closed", n=3)
    for stage in ("upload", "fft", "demod", "clone"):
        assert cells.reader(f"{stage}_dev_ms.sat")(run) is None


def _late_run():
    """An open loop of 50 blocks: block 10's upload stalls 40 ms, so it
    and block 11 (called late behind it) land after the next was due;
    block 11 has no row."""
    period = 0.02
    run = Run({"groups": [["FM", 8]], "L": 100}, "cpu", 1.0, "open", period)
    rows, t_free = [], 0.0
    for i in range(50):
        due = 100.0 + (i + 1) * period
        call = max(due, t_free)
        start = call + 1e-5
        put = start + 0.0005 + (0.040 if i == 10 else 0.0)
        stagein, launch, end = put + 0.0001, put + 0.0003, put + 0.0015
        ret = end + 1e-5
        run.blocks.append(Block(i, due=due, call=call, ret=ret,
                                done=ret + 0.004))
        run.dev_ms.append((0.0, 4.5, 4.7))
        t_free = ret
        if i != 11:
            rows.append(_row(i, start, put, end, stagein, launch))
    return run, rows


def test_late_blocks_split(monkeypatch):
    run, rows = _late_run()
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake(rows))
    late = recorder.late(run)
    assert [d["block"] for d in late] == [10, 11]
    a, b = late
    assert a["put"] == pytest.approx(40.5) and a["late"] == pytest.approx(0)
    assert a["stagein"] == pytest.approx(0.1)
    assert a["launch"] == pytest.approx(0.2)
    assert a["clone"] == pytest.approx(1.2)
    assert a["call"] == pytest.approx(42.02)
    assert a["device"] == pytest.approx(4.5)
    assert a["put"] + a["stagein"] + a["launch"] + a["clone"] <= a["call"]
    assert b["late"] == pytest.approx(22.02) and b["put"] is None
    monkeypatch.setattr(recorder, "program_trace", lambda: None)
    assert [d["put"] for d in recorder.late(run)] == [None, None]


def test_lateblocks_prints_each_late_block(monkeypatch, capsys):
    import json

    import torch

    from sdrbench import lateblocks

    run, rows = _late_run()
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake(rows))
    monkeypatch.setattr(lateblocks, "serve_window", lambda *a: run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    assert lateblocks.main(["--workload", "mixed6144-live", "--seed",
                            str(2**31 + 5), "--seconds", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("block 10: due_to_done 46.")
    assert "put 40.500" in out[0] and "put -" in out[1]
    line = json.loads(out[-1])
    assert line["late"] == 2 and line["blocks"] == 50
    assert [d["block"] for d in line["late_blocks"]] == [10, 11]


def test_capture_seconds(monkeypatch):
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake(
        captures=[("('i16', True)", 0.4), ("('active', 64, None)", 0.3)]))
    run, _ = _run("closed", n=3)
    assert cells.reader("capture_s")(run) == pytest.approx(0.7)
    monkeypatch.setattr(recorder, "program_trace", lambda: _fake())
    assert cells.reader("capture_s")(run) is None


NEW = ("put_host_ms.sat", "put_host_ms.live", "launch_host_ms.sat",
       "launch_host_ms.live", "put_tail_ms.live", "launch_tail_ms.live",
       "upload_dev_ms.sat", "stagein_dev_ms.sat",
       "clone_dev_ms.sat", "ingest_dev_ms.sat", "fft_dev_ms.sat",
       "channelize_dev_ms.sat", "demod_dev_ms.sat", "pack_dev_ms.sat",
       "capture_s")


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_a_recorder_gives_no_number(monkeypatch, name):
    monkeypatch.setattr(recorder, "program_trace", lambda: None)
    for loop in ("open", "closed"):
        run, _ = _run(loop, n=3)
        assert cells.reader(name)(run) is None


def test_every_served_block_finds_its_row():
    """The harness's open loop over a tiny CPU bank: each block's row lies
    inside its [call, ret], and put + launch is the entry's wall time."""
    import torch

    from sdrbench import generator, program, serve
    from sdrbench.tests import tiny

    trace = recorder.program_trace()
    trace.reset()
    cfg = tiny.config("mixed6144_20ms")
    groups = program.channel_freqs(cfg)
    plan = generator.draw(groups, float(cfg["samprate"]),
                          tiny.traffic("live")["signals"], 2**31 + 7)
    blocks = generator.make_loop(plan, cfg["L"], 0.01, 2**31 + 7, "cpu")
    device = torch.device("cpu")
    system = program.System(cfg, True, device)
    out = system.call(blocks[0])
    egress = serve.Egress(out, 1, device)
    win = serve.run_window(system.call, blocks, egress, device, loop="open",
                           seconds=0.0, period=0.02, count=8)
    run = Run(cfg, "cpu", 0.16, "open", 0.02)
    run.blocks = win.blocks
    s = recorder.split(run)
    assert s["matched"] == len(run.blocks) == 8
    rows = trace.rows()
    assert rows.shape[0] == 9                 # and the warm-up call's
    for b, put, launch in zip(run.blocks, s["put"], s["launch"]):
        assert put + launch <= (b.ret - b.call) * 1e3
    trace.reset()

