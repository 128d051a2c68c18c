"""The program's own records, for the per-layer metrics that read them
and for ``lateblocks`` (``late``): the port's block recorder, its
detailed calls' stages and its captures
(``ka9q_sdr_tpu_torch.utils.trace``), read from its process-wide store
once a run has ended.  A program without that module (an older checkout)
gives None here, and the metrics that read it are left out of the result
line.

A window block's row is matched by host time: the row whose start and
end lie inside the block's ``[call, ret]`` (the recorder stamps
``perf_counter_ns``, the clock ``serve`` stamps blocks with); a block
with no such row has no split."""

from __future__ import annotations

import numpy as np


def program_trace():
    """The program's tracer module, or None where it has none."""
    try:
        from ka9q_sdr_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def match(calls, rets, starts, ends) -> np.ndarray:
    """For each block's [call, ret] (s) the index of the row whose [start,
    end] (s) lies inside it, -1 where none does; rows sorted by start."""
    calls, rets = np.asarray(calls, float), np.asarray(rets, float)
    starts, ends = np.asarray(starts, float), np.asarray(ends, float)
    i = np.searchsorted(starts, calls, side="left")
    ok = i < len(starts)
    j = np.where(ok, i, 0)
    if len(starts):
        ok &= (starts[j] <= rets) & (ends[j] <= rets)
    return np.where(ok, i, -1)


def _matched(run):
    """The program's rows sorted by start, their column indices by name,
    and each window block's row (-1 where none); None where the program
    records no rows."""
    tr = program_trace()
    if tr is None or not run.blocks:
        return None
    rows = tr.rows()
    if not len(rows):
        return None
    c = {name: k for k, name in enumerate(tr.COLUMNS)}
    rows = rows[np.argsort(rows[:, c["start"]], kind="stable")]
    idx = match([b.call for b in run.blocks], [b.ret for b in run.blocks],
                rows[:, c["start"]] * 1e-9, rows[:, c["end"]] * 1e-9)
    return rows, c, idx


def split(run) -> dict | None:
    """Each window block's split from its row, ms: ``put`` (the entry's
    start to its upload's end) and ``launch`` (from there to its end: the
    static-input copy, the replay's launch, the clones), NaN for a block
    with no row; and ``matched``, the blocks with one.  None where the
    program records no rows."""
    m = _matched(run)
    if m is None:
        return None
    rows, c, idx = m
    got = idx >= 0
    r = rows[np.where(got, idx, 0)].astype(np.float64)
    out = {"put": r[:, c["put"]] - r[:, c["start"]],
           "launch": r[:, c["end"]] - r[:, c["put"]]}
    out = {k: np.where(got, v * 1e-6, np.nan) for k, v in out.items()}
    out["matched"] = int(got.sum())
    return out


def late(run) -> list:
    """Each late block of an open loop (its outputs on the host after the
    next block was due), with where its time went, ms: ``late`` (the
    call after its due time), ``call`` and ``wait`` (the host's clock
    around the entry and the copy's wait), from its row ``put``,
    ``stagein`` (the static-input copy), ``launch`` (the replay's launch)
    and ``clone`` (the rest of the call), None where it has no row; and
    ``device`` (the harness's events around the call) where recorded."""
    m = _matched(run)
    rows, c, idx = m if m is not None else (None, {}, [-1] * len(run.blocks))
    out = []
    for i, b in enumerate(run.blocks):
        if b.done <= b.due + run.period:
            continue
        d = {"block": b.index, "due_to_done": (b.done - b.due) * 1e3,
             "late": (b.call - b.due) * 1e3, "call": (b.ret - b.call) * 1e3,
             "wait": (b.done - b.ret) * 1e3}
        if idx[i] >= 0:
            r = rows[idx[i]]
            # an eager call copies no static input: its stagein stays 0
            stagein = r[c["stagein"]] or r[c["put"]]
            for k, (a, z) in {"put": (r[c["start"]], r[c["put"]]),
                              "stagein": (r[c["put"]], stagein),
                              "launch": (stagein, r[c["launch"]]),
                              "clone": (r[c["launch"]], r[c["end"]])
                              }.items():
                d[k] = (int(z) - int(a)) * 1e-6
        else:
            d.update(dict.fromkeys(("put", "stagein", "launch", "clone")))
        if i < len(run.dev_ms) and run.dev_ms[i]:
            d["device"] = run.dev_ms[i][1] - run.dev_ms[i][0]
        out.append(d)
    return out


def slowest(run, share: float = 0.05) -> np.ndarray:
    """The indices of the window's slowest `share` of blocks by latency
    (due to outputs on the host), at least one."""
    lat = np.array([b.done - b.due for b in run.blocks])
    return np.argsort(lat, kind="stable")[-max(1, int(len(lat) * share)):]


def host_ms(run, part: str, loop: str, tail: bool = False) -> float | None:
    """The median of a part of the split over the window's blocks (`tail`:
    over its slowest 5%), for a run of `loop`."""
    if run.loop != loop:
        return None
    s = split(run)
    if s is None or not s["matched"]:
        return None
    v = s[part][slowest(run)] if tail else s[part]
    v = v[~np.isnan(v)]
    return float(np.median(v)) if len(v) else None


def stage_ms(run, stage: str) -> float | None:
    """The median over the traced span's blocks of a stage's device ms,
    summed over its groups (``g<i>.<stage>``); a closed loop's.  None
    where the harvest dropped a call (``stage_missed``)."""
    tr = program_trace()
    if tr is None or run.loop != "closed":
        return None
    if getattr(tr, "stage_missed", 0):
        return None
    per = [sum(v for k, v in ms.items()
               if k == stage or k.endswith("." + stage))
           for _, _, ms in tr.stages()
           if any(k == stage or k.endswith("." + stage) for k in ms)]
    return float(np.median(per)) if per else None


def capture_s() -> float | None:
    """The seconds of every capture the run made (its set-up's)."""
    tr = program_trace()
    if tr is None:
        return None
    caps = tr.captures()
    return float(sum(s for _, s in caps)) if caps else None
