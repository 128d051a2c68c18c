"""The readers of the program's upload counters (``sdrbench/uploads.py``,
``upload_overlap_pct.sat`` and ``.live``): None for a program without the
counters (an older checkout) or that counted no upload, the share of
overlapped uploads with them, each for its own loop only; and on a tiny
CPU bank served by the harness's loop, every upload inline."""

import types

import pytest

from sdrbench import cells, recorder
from sdrbench.run import Run

READERS = {"upload_overlap_pct.sat": "closed",
           "upload_overlap_pct.live": "open"}


def _run(loop):
    return Run({"groups": [["FM", 8]], "L": 100}, "cpu", 1.0, loop, 0.02)


def _counts(overlapped, inline):
    return types.SimpleNamespace(upload_overlapped=overlapped,
                                 upload_inline=inline)


@pytest.mark.parametrize("name", sorted(READERS))
def test_no_counters_no_number(monkeypatch, name):
    loop = READERS[name]
    monkeypatch.setattr(recorder, "program_trace", lambda: None)
    assert cells.reader(name)(_run(loop)) is None
    # a tracer from before the counters
    monkeypatch.setattr(recorder, "program_trace",
                        lambda: types.SimpleNamespace(stage_missed=0))
    assert cells.reader(name)(_run(loop)) is None
    monkeypatch.setattr(recorder, "program_trace", lambda: _counts(0, 0))
    assert cells.reader(name)(_run(loop)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_share_of_overlapped_uploads(monkeypatch, name):
    loop = READERS[name]
    other = "open" if loop == "closed" else "closed"
    monkeypatch.setattr(recorder, "program_trace", lambda: _counts(3, 1))
    assert cells.reader(name)(_run(loop)) == pytest.approx(75.0)
    assert cells.reader(name)(_run(other)) is None
    monkeypatch.setattr(recorder, "program_trace", lambda: _counts(502, 0))
    assert cells.reader(name)(_run(loop)) == pytest.approx(100.0)


def test_a_cpu_bank_uploads_inline():
    """The harness's closed loop over a tiny CPU bank: the program counts
    every upload, and none overlaps (the CPU has no copy stream)."""
    import torch

    from sdrbench import generator, program, serve
    from sdrbench.tests import tiny

    trace = recorder.program_trace()
    trace.reset()
    cfg = tiny.config("fm_pl_4096_20ms")
    groups = program.channel_freqs(cfg)
    plan = generator.draw(groups, float(cfg["samprate"]),
                          tiny.traffic("sat")["signals"], 2**31 + 9)
    blocks = generator.make_loop(plan, cfg["L"], 0.01, 2**31 + 9, "cpu")
    device = torch.device("cpu")
    system = program.System(cfg, False, device)
    out = system.call(blocks[0])
    egress = serve.Egress(out, serve.DEPTH, device)
    serve.run_window(system.call, blocks, egress, device, loop="closed",
                     seconds=0.0, period=0.02, count=5)
    assert (trace.upload_overlapped, trace.upload_inline) == (0, 6)
    assert cells.reader("upload_overlap_pct.sat")(_run("closed")) == 0.0
    trace.reset()
