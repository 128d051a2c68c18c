"""Device time of a kernel call alone, and the device trace of a span of
blocks.

``cold_ms`` times a call with CUDA events, the L2 flushed before each
run (a 256 MB ``bitwise_not_`` over a buffer, timed on its own and taken
back out), while a spin kernel holds the card until the host has queued
every run, so no host gap counts.

``Trace`` runs ``torch.profiler`` over a span of blocks and reduces
its export: the union of the device's activity (kernels, copies, sets)
as ``busy_s``, the device operations that took most time, and the
longest idle gaps labelled by the benchmark's host span they fell in
(``sdrbench.call``, ``.egress``, ``.wait``, or the open loop's wait for
the next block).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from .yardstick import merged

CLOCK_HZ = 1.98e9          # only sizes the spin


def cold_ms(fn, reps: int = 20) -> float:
    """Median device ms of fn() with the L2 flushed before each run."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    flush.bitwise_not_()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(0.05 * CLOCK_HZ))
    for a, b, c in ev:
        a.record()
        flush.bitwise_not_()
        b.record()
        fn()
        c.record()
    torch.cuda.synchronize()
    return float(np.median([b.elapsed_time(c) for a, b, c in ev]))


_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Trace:
    """torch.profiler around a span of blocks served after the window."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.start()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()

    def reduce(self) -> dict | None:
        """{busy_s, window_s, device_ops, idle_gaps}, or None where the
        trace holds no device activity."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_events(events)


def reduce_events(events) -> dict | None:
    """The trace's device busy time, top operations and idle gaps."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?"))
           for e in events if e.get("cat") in _DEVICE_CATS and "ts" in e]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("sdrbench.")]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
            and "ts" in e]
    if not dev or not host:
        return None
    t0 = min(e["ts"] for e in host)
    t1 = max(e["ts"] + e.get("dur", 0) for e in host)
    spans_on = merged((a, b) for a, b, _ in dev)
    busy = sum(b - a for a, b in spans_on)
    gaps = [(x[1], y[0]) for x, y in zip(spans_on, spans_on[1:])]
    ops: dict = {}
    for a, b, name in dev:
        ops[name] = ops.get(name, 0.0) + (b - a)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]

    def label(a, b):
        mid = (a + b) / 2
        for s, e, name in spans:
            if s <= mid <= e:
                return name
        return "sdrbench.between_blocks"

    idle: dict = {}
    for a, b in gaps:
        k = label(a, b)
        idle[k] = idle.get(k, 0.0) + (b - a)
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "device_ops": [[n[:96], v * 1e-6] for n, v in top],
            "idle_gaps": [[n, v * 1e-6] for n, v in worst]}
