"""The benchmark's arithmetic: rates, percentiles, idle shares, and the
bytes a kernel must move, all from numbers the harness recorded or
from shapes.  Nothing here reads the program."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0-100) by the nearest rank: the smallest value
    with at least q% of the values at or below it; None for no values."""
    v = sorted(values)
    if not v:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[rank - 1])


def median(values) -> float | None:
    v = list(values)
    return float(np.median(v)) if v else None


def ch_msps(n_channels: int, L: int, blocks_done: int, seconds: float) -> float:
    """channels x Msps served: n_channels x L x blocks / seconds / 1e6."""
    return n_channels * L * blocks_done / seconds / 1e6


def blocks_within(done_ms, seconds: float) -> int:
    """How many blocks' outputs reached the host within the window (their
    completion time, ms from the window's start, at most seconds)."""
    return int(sum(1 for t in done_ms if t <= seconds * 1e3))


def latencies_ms(due_s, done_s) -> list:
    """Each block's time from due to its outputs on the host, ms."""
    return [(b - a) * 1e3 for a, b in zip(due_s, done_s)]


def late_blocks(done_s, due_s, period_s: float) -> int:
    """Blocks whose outputs reached the host after the next block was
    due."""
    return int(sum(1 for d, t in zip(due_s, done_s) if t > d + period_s))


def merged(intervals) -> list:
    """The union of [start, end] intervals: sorted, disjoint [a, b]."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_pct(busy: float, window: float) -> float | None:
    """100 x (1 - busy / window); None for an empty window."""
    return 100.0 * (1.0 - busy / window) if window > 0 else None


def fill_bytes(B: int, T: int) -> int:
    """The bytes the FM demodulator's two fills at (B, T) must move: the
    complex64 fill reads its values (8 B) and the mask (1 B) and writes its
    output (8 B) per sample, and reads an 8 B initial value a row; the
    float32 fill 4 + 1 + 4 per sample and 4 a row."""
    n = B * T
    return n * (8 + 1 + 8) + B * 8 + n * (4 + 1 + 4) + B * 4


def agc_bytes(B: int, T: int, calls: int = 1) -> int:
    """The bytes `calls` hang-AGC calls at (B, T) must move: each reads a
    float32 level and writes a float32 gain per sample, and reads and
    writes a float32 gain and an int32 hang count a row."""
    return calls * (B * T * 8 + B * 16)


def roofline_pct(nbytes: int, measured_s: float, device: str) -> float | None:
    """100 x the least time (bytes over the device's memory bandwidth) over
    the measured time; None for a device the peaks table lacks."""
    peak = PEAKS.get(device)
    if peak is None or not measured_s > 0:
        return None
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / measured_s
