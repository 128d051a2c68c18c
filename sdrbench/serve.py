"""The serving loop: the benchmark's own copy of bankd's pattern (one
thread: a block in, the entry called, its outputs copied to pinned host
memory behind an event, a few blocks' copies in flight).

- ``closed``: the next block is called as soon as the previous call has
  returned, with `DEPTH` blocks' copies outstanding (bankd keeps three);
  a block counts once its copy has landed.
- ``open``: block b is due when its last sample arrives on the wire
  schedule, t0 + (b + 1) L / fs; it is called at its due time or,
  when the loop runs late, as soon as the previous block's outputs are on
  the host.  The loop waits for each block's copy (one in flight), so a
  stall delays the blocks behind it, and each block's latency counts from
  its due time.

Every block records host times (due, call, return, outputs on the host)
and three CUDA events on the entry's stream (before the call, after it
returns, after the copy), read once the window has closed.  On the CPU
(the tests) the events are host stamps.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from torch.profiler import record_function

#: blocks' copies the closed loop keeps in flight, as bankd does
DEPTH = 3


class _HostEvent:
    """A CPU stand-in for a CUDA event (the CPU runs in order)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


@dataclass
class Block:
    index: int
    due: float = 0.0          # host s
    call: float = 0.0
    ret: float = 0.0
    done: float = 0.0
    ev: tuple = ()            # (before, after, copied)
    slot: int = 0
    error: str = ""


@dataclass
class Window:
    """What a window recorded."""

    seconds: float
    loop: str
    period: float
    blocks: list = field(default_factory=list)
    start_event: object = None
    start: float = 0.0

    def device_ms(self):
        """Per block (before, after, copied) in device ms from the
        window's start event."""
        s = self.start_event
        return [tuple(s.elapsed_time(e) for e in b.ev) if b.ev else None
                for b in self.blocks]


class Egress:
    """Pinned host buffers for `slots` blocks' outputs, reused in turn."""

    def __init__(self, example: dict, slots: int, device):
        pin = device.type == "cuda"
        self.bufs = [{k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                      for k, t in example.items()} for _ in range(slots)]
        self.slots = slots

    def start(self, outs: dict, slot: int) -> None:
        buf = self.bufs[slot]
        for k, t in outs.items():
            buf[k].copy_(t, non_blocking=True)

    def host(self, slot: int) -> dict:
        return {k: v.numpy() for k, v in self.bufs[slot].items()}


def _wait_until(t: float) -> None:
    """Sleep to 4 ms before `t`, then spin: a sleep's wake-up is late by
    up to milliseconds on a busy host."""
    left = t - time.perf_counter()
    if left > 4e-3:
        time.sleep(left - 4e-3)
    while time.perf_counter() < t:
        pass


def run_window(call, blocks: np.ndarray, egress: Egress, device, *,
               loop: str, seconds: float, period: float, keep=None,
               count: int = 0, first: int = 0) -> Window:
    """Serve `blocks` in order (wrapping) for `seconds`, or `count`
    blocks where given, numbering them from `first`.

    call(x) -> {name: tensor}; keep(block, host_outputs) is called once
    each block's copy has landed (it keeps what the comparison reads)."""
    if loop not in ("closed", "open"):
        raise ValueError(f"unknown loop {loop!r}")
    nb = blocks.shape[0]
    win = Window(seconds, loop, period)
    depth = DEPTH if loop == "closed" else 1
    pending: deque = deque()

    def land(b: Block):
        b.ev[2].synchronize()
        b.done = time.perf_counter()
        if keep is not None and not b.error:
            keep(b.index, egress.host(b.slot))

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # no cyclic collection inside the window: what the loop keeps would
    # otherwise trigger one at random blocks
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        win.start_event = _event(device)
        win.start = time.perf_counter()
        win.start_event.record()
        t0, i = win.start, first
        while True:
            now = time.perf_counter()
            if count and i - first >= count:
                break
            if loop == "closed":
                if not count and now - t0 >= seconds:
                    break
                due = now
            else:
                due = t0 + (i - first + 1) * period
                if not count and due - t0 > seconds + 1e-9:
                    break
                _wait_until(due)
            b = Block(i, due=due, slot=i % egress.slots)
            ev = (_event(device), _event(device), _event(device))
            with record_function("sdrbench.call"):
                ev[0].record()
                b.call = time.perf_counter()
                try:
                    outs = call(blocks[i % nb])
                except RuntimeError as e:       # counted as failed
                    b.error = f"{type(e).__name__}: {e}"
                    outs = None
                b.ret = time.perf_counter()
                ev[1].record()
            with record_function("sdrbench.egress"):
                if outs is not None:
                    egress.start(outs, b.slot)
                ev[2].record()
            b.ev = ev
            win.blocks.append(b)
            pending.append(b)
            if len(pending) >= depth:
                with record_function("sdrbench.wait"):
                    land(pending.popleft())
            i += 1
        while pending:
            land(pending.popleft())
    finally:
        if collecting:
            gc.enable()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return win
