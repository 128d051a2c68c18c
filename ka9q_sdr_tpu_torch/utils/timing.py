"""Device time on a CUDA card, for the measurement tools and the smoke
script: CUDA events around work the host queued while a spin kernel held
the card, so host enqueue gaps do not count.

These time the current CUDA device and need one; the tools time the host
clock instead under ``--cpu``.
"""

from __future__ import annotations

import time

import torch

__all__ = ["cuda_ms", "span_ms", "device_ms", "CLOCK_HZ"]

#: the H100's boost clock, used only to size torch.cuda._sleep spins
CLOCK_HZ = 1.98e9


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` calls, after a warm-up
    (CUDA events around the calls as the host queues them)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def span_ms(calls) -> float:
    """Device time of the work that calls() queues: CUDA events around it
    while a spin kernel holds the device until all of it is queued, so no
    enqueue gap of the host counts (unlike cuda_ms).  calls() runs twice or
    more: the first run, unspun, measures how long the host takes to queue
    it.
    Where the host had to wait for the device to queue it (a host sync, or
    more launches than the device's launch queue holds, about a thousand),
    the span would hold host time: nan, with a note.  A host stall that
    outlasts the spin once is retried twice with a spin four times longer;
    a step that waits for the device outlasts every spin."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = 4 * host + 5e-3
    for _ in range(3):
        torch.cuda._sleep(int(spin * CLOCK_HZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        calls()
        end.record()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued < spin:
            return start.elapsed_time(end)
        spin *= 4
    print(f"  (not measured: queuing took {queued * 1e3:.1f} ms, past "
          f"the {spin / 4 * 1e3:.1f} ms spin)", flush=True)
    return float("nan")


def device_ms(fn, iters: int, cold: bool = False) -> float:
    """Device time per call of fn() (see span_ms): warm, `iters` calls
    queued back to back; cold, each call timed alone after overwriting 128
    MB (more than the H100's 50 MB L2), as a caller whose inputs were
    written long before would find it, less the overwrite's own span."""
    if not cold:
        def calls():
            for _ in range(iters):
                fn()
        return span_ms(calls) / iters
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    total = 0.0
    for _ in range(iters):
        total += (span_ms(lambda: (flush.bitwise_not_(), fn()))
                  - span_ms(flush.bitwise_not_))
    return total / iters
