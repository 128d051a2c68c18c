"""The port's tracer: a block recorder that is always on, stage marks
inside the compiled steps, and spans on the profiler's clock while a
``torch.profiler`` session records.

**Block recorder.**  Every entry call of ``ChannelBank`` and ``MultiBank``
(``entry``) takes a row of a preallocated ring of `RING` rows and stamps
``time.perf_counter_ns()`` at its start, at the end of its upload
(``_put``), at the end of the copy into the graph's static input, after
the replay's launch and at its end (the output clones queued), with a
sequence number and the variant (`COLUMNS`).  (The thread's
CPU clock is left out: on the H100 hosts it was measured on, a read was a
system call of 0.05-0.08 ms, now and then milliseconds, counting in 10 ms
ticks.)  A call allocates nothing and takes no lock:
its row is its own (``next`` of an ``itertools.count``, atomic under the
GIL), so daemons that share a process on threads write rows of their own.
``perf_counter_ns`` is the clock of ``time.perf_counter``, so a caller's
host interval around a call holds the call's row.  ``rows()`` reads the
finished rows.

**Stage marks.**  The step functions (``models.bank``) mark where each
stage of a block starts (``mark``): ``ingest`` (the int16 scaling, the
gain and the overlap ``cat``), ``fft``, then per group ``g<i>.channelize``
(recenter, gather, channelize), ``g<i>.demod`` (the gates' IF nodes
included) and ``g<i>.pack`` (PCM, compaction); ``StepGraphs`` closes them
with ``end`` after the state write-back.  Inside a capture each mark is a
one-thread kernel node that writes the device's %globaltimer to a slot of
a device buffer (``Stamps``, ``csrc/cond.cu`` ``graph_stamp``), so
every replay stamps them again.  The buffer holds the marks the capture's
warm-up passed, counted as it runs; a capture that makes more keeps none
(``Stamps.add``): the tracer never fails the step it observes.  (Timing CUDA events recorded as
event-record nodes cost about 5 us of device time each on an H100.)  A
mark that repeats the stage already open adds nothing, and a scan's steps
(``unmarked``) add none.

**The detailed level** is on for a call while a profiler session records
(the profiler's own flag, ``torch.autograd.profiler._is_profiler_enabled``,
read once a call).  The host phases then also enter
``record_function("ka9q.put" | "ka9q.stagein" | "ka9q.replay" |
"ka9q.clone" | "ka9q.capture")``, so they sit on the trace's timeline with
the device's operations; events are recorded around the upload, the
static-input copy and the clones (stages ``upload``, ``stagein``,
``clone``; an upload that overlaps the block before has its events on
the copy stream, around the copy); and the call's marks are kept (a
captured step's stamps are copied to pinned memory of the call's own
behind an event).  They are harvested at the thread's next call, after
its upload, or by ``stages()``: a call whose events have all completed
(``query()``), never by waiting; one still running stays pending.  A
call is counted in ``stage_missed`` (the stage metrics then read
nothing) where it is still running when ``stages()`` reads, or where it
is dropped because more than `PENDING` calls are pending.  On
the CPU, or with the graphs off, the marks are recorded as the step runs
(host stamps on the CPU).

**Captures.**  Each ``StepGraphs`` capture records its variant and its
seconds (``captured``, ``captures()``).

**Uploads.**  ``upload_overlapped`` and ``upload_inline`` count the
entries' uploads, process-wide, by path (``uploaded``): copied on a copy
stream while the block before runs, or synchronously.

``sdrbench/lateblocks.py`` prints the recorder's split of each late block
of a served window.
"""

from __future__ import annotations

import array
import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from functools import wraps

import numpy as np
import torch
from torch.autograd import profiler as _profiler

__all__ = ["RING", "PENDING", "COLUMNS", "Stamps", "entry", "span",
           "close", "put_done", "replayed", "mark", "close_marks",
           "capture_marks", "capture_end", "unmarked", "captured",
           "uploaded", "rows", "variant_names", "stages", "captures",
           "last_split", "stage_missed", "upload_overlapped",
           "upload_inline", "reset"]

#: rows of the block recorder's ring
RING = 16384

#: a thread's detailed calls the harvest keeps pending at most
PENDING = 64

#: a row of the ring: perf_counter_ns at the entry's start, its upload's
#: end, the static-input copy's end, after the replay's launch and at its
#: end; the call's sequence number and variant (an index of
#: ``variant_names()``)
COLUMNS = ("start", "put", "stagein", "launch", "end", "seq", "variant")
START, PUT, STAGEIN, LAUNCH, END, SEQ, VARIANT = range(len(COLUMNS))
_NCOL = len(COLUMNS)

_ring = array.array("q", bytes(8 * RING * _NCOL))
_seq = itertools.count()
_variants: list = []
_stages: deque = deque(maxlen=RING)      # (seq, variant, {stage: ms})
_captures: list = []                     # (variant, seconds)
_count_lock = threading.Lock()            # the counts below

#: detailed calls still running when ``stages()`` read, or dropped past
#: `PENDING`
stage_missed = 0

#: entry uploads copied on a copy stream while the block before ran, and
#: those copied synchronously
upload_overlapped = 0
upload_inline = 0


class _Thread(threading.local):
    """What one thread's current call has open."""

    def __init__(self):
        self.base = -1          # the call's row offset; -1 outside a call
        self.last = -1          # the last finished call's
        self.detail = False     # a profiler session records this call
        self.items = []         # the call's marked intervals (detailed)
        self.open = []          # marks of an eager step (detailed)
        self.pending = []       # (seq, variant, items) of earlier calls
        self.cap = None         # a capture's marks, while one runs
        self.quiet = 0          # inside a scan's steps


_t = _Thread()


class _HostEvent:
    """A CPU stand-in for a CUDA event (the CPU runs in order)."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device, stream=None):
    """A timing event recorded now on `stream` (the current stream of
    `device` where None)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream or torch.cuda.current_stream(device))
        return ev
    ev = _HostEvent()
    ev.record()
    return ev


def entry(variant: str):
    """Decorator of a host wrapper's entry call: one row of the ring a
    call (a call inside another entry's is part of it)."""
    vid = len(_variants)
    _variants.append(variant)

    def wrap(fn):
        @wraps(fn)
        def call(*args, **kwargs):
            started = _begin(vid)
            try:
                return fn(*args, **kwargs)
            finally:
                if started:
                    _end()
        return call
    return wrap


def _begin(vid: int) -> bool:
    t = _t
    if t.base >= 0:
        return False
    seq = next(_seq)
    base = (seq % RING) * _NCOL
    r = _ring
    r[base + END] = 0
    r[base + START] = time.perf_counter_ns()
    r[base + PUT] = 0
    r[base + STAGEIN] = 0
    r[base + LAUNCH] = 0
    r[base + SEQ] = seq
    r[base + VARIANT] = vid
    t.base = base
    if _profiler._is_profiler_enabled:
        t.detail = True
        t.items = []
    return True


def _end() -> None:
    t = _t
    base = t.base
    r = _ring
    r[base + END] = time.perf_counter_ns()
    t.base = -1
    t.last = base
    if t.detail:
        t.detail = False
        if t.items:
            t.pending.append((r[base + SEQ], r[base + VARIANT], t.items))
        t.items = []


def _stamp(col: int) -> None:
    base = _t.base
    if base >= 0:
        _ring[base + col] = time.perf_counter_ns()


def span(name: str, device=None, stage: str | None = None, stream=None):
    """Open the host phase ``ka9q.<name>`` of a detailed call, and where
    `stage` is given an event on `device` where that stage starts (on
    `stream`, where given, and its end too).  None (nothing opened)
    unless the call is detailed."""
    if not _t.detail:
        return None
    rf = _profiler.record_function("ka9q." + name)
    rf.__enter__()
    return (rf, stage, device, _event(device, stream) if stage else None,
            stream)


def close(tok, col: int = -1) -> None:
    """Stamp column `col` of the call's row (where given), then close what
    `span` opened: the stage's end event, the host phase."""
    if col >= 0:
        _stamp(col)
    if tok is None:
        return
    rf, stage, device, ev, stream = tok
    if ev is not None:
        _t.items.append(_Events([(stage, ev),
                                 ("end", _event(device, stream))]))
    rf.__exit__(None, None, None)


def put_done(tok) -> None:
    """The end of an entry's upload (of its enqueue, where it overlaps):
    stamp it, close its span, and harvest the thread's earlier detailed
    calls whose events have completed."""
    close(tok, PUT)
    t = _t
    if t.pending:
        _harvest(t)


def uploaded(overlapped: bool) -> None:
    """Count one entry upload by its path."""
    global upload_overlapped, upload_inline
    with _count_lock:
        if overlapped:
            upload_overlapped += 1
        else:
            upload_inline += 1


def replayed(tok, marks) -> None:
    """After a graph's launch: stamp it; for a detailed call queue the
    read of the graph's `marks` (``Stamps``, or None) and close the
    replay's span."""
    _stamp(LAUNCH)
    if tok is not None:
        if marks is not None:
            _t.items.append(marks.queue())
        tok[0].__exit__(None, None, None)


class _Events:
    """Marks of an eager step: (stage, event) pairs, the last ``end``."""

    def __init__(self, pairs):
        self.pairs = pairs

    def query(self) -> bool:
        return self.pairs[-1][1].query()

    def intervals(self):
        return [(name, a.elapsed_time(b)) for (name, a), (_, b)
                in zip(self.pairs, self.pairs[1:])]


class Stamps:
    """The stage marks of a captured step: a kernel node a mark
    (``csrc/cond.cu`` ``graph_stamp``) that writes the device's
    %globaltimer to its slot of `buf` on every replay.  `buf` has a slot
    for each mark the warm-up passed (``plan``) and the ``end``.  A
    detailed call queues a copy of the slots to pinned memory behind an
    event (``queue``); the harvest reads them once the event has
    completed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.plan: list = []    # the warm-up's marks
        self.names: list = []   # the capture's
        self.buf = None
        self.lost = False       # the capture made more marks than the plan

    def add(self, name: str) -> None:
        """A mark inside the capture: one stamp kernel.  Past the plan's
        slots it stamps nothing, and the capture keeps no marks."""
        if self.buf is None:
            self.buf = torch.empty(len(self.plan) + 1, dtype=torch.int64,
                                   device=self.device)
        if self.lost or len(self.names) == self.buf.numel():
            self.lost = True
            return
        from .graphs import _cond_check, _cond_lib

        lib = _cond_lib(self.device.index)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _cond_check(lib, lib.graph_stamp(
            self.device.index, self.buf[len(self.names)].data_ptr(), stream),
            "a stage mark")
        self.names.append(name)

    def finish(self) -> "Stamps | None":
        """After the capture: itself, or None where no mark was made or
        some were lost."""
        if not self.names or self.lost:
            return None
        return self

    def queue(self) -> "_Copied":
        """After a replay: its stamps copied to pinned memory of their own
        behind an event (calls still pending keep theirs)."""
        host = torch.empty(len(self.names), dtype=torch.int64,
                           pin_memory=True)
        host.copy_(self.buf[:len(self.names)], non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return _Copied(self.names, host, done)

    def read(self):
        """The last replay's (stage, ms), waiting for it (tests)."""
        c = self.queue()
        c.done.synchronize()
        return c.intervals()


class _Copied:
    """One replay's stamps on their way to the host."""

    def __init__(self, names, host, done):
        self.names, self.host, self.done = names, host, done

    def query(self) -> bool:
        return self.done.query()

    def intervals(self):
        t = self.host.tolist()
        return [(name, (b - a) * 1e-6) for name, a, b
                in zip(self.names, t, t[1:])]


def mark(stage: str, like: torch.Tensor, group: int | None = None) -> None:
    """`stage` (of group `group`) starts here, in the step that runs on
    `like`'s device."""
    t = _t
    if t.quiet:
        return
    cap = t.cap
    if cap is not None:
        # inside a StepGraphs capture; its warm-up counts the marks
        name = stage if group is None else f"g{group}.{stage}"
        if not torch.cuda.is_current_stream_capturing():
            if not cap.plan or cap.plan[-1] != name:
                cap.plan.append(name)
        elif not cap.names or cap.names[-1] != name:
            cap.add(name)
        return
    if t.detail:
        name = stage if group is None else f"g{group}.{stage}"
        if not t.open or t.open[-1][0] != name:
            t.open.append((name, _event(like.device)))


def close_marks(device) -> None:
    """After a step's state write-back: the ``end`` of its marks."""
    t = _t
    if t.cap is not None:
        if t.cap.names and torch.cuda.is_current_stream_capturing():
            t.cap.add("end")
        return
    if t.open:
        t.open.append(("end", _event(device)))
        if t.detail:
            t.items.append(_Events(t.open))
        t.open = []


def capture_marks(device: torch.device) -> None:
    """A StepGraphs capture on `device` (with its index) starts on this
    thread, its warm-up first; the stamp kernel's module loads here,
    outside the capture."""
    from .graphs import _cond_lib

    _cond_lib(device.index)
    _t.cap = Stamps(device)


def capture_end():
    """The capture's marks (``Stamps``), None where it made none."""
    t = _t
    cap, t.cap = t.cap, None
    return cap.finish() if cap is not None else None


@contextmanager
def unmarked():
    """A scan's steps: no marks."""
    _t.quiet += 1
    try:
        yield
    finally:
        _t.quiet -= 1


def captured(variant: str, seconds: float) -> None:
    """Record one capture."""
    _captures.append((variant, float(seconds)))


def _harvest(t, final: bool = False) -> None:
    """Keep the stages of the thread's pending calls whose events have
    all completed; keep the others pending, at most `PENDING` of them, or
    (`final`) count them missed."""
    global stage_missed
    running = []
    for call in t.pending:
        seq, vid, items = call
        if not all(it.query() for it in items):
            running.append(call)
            continue
        ms: dict = {}
        for it in items:
            for name, v in it.intervals():
                ms[name] = ms.get(name, 0.0) + v
        _stages.append((seq, _variants[vid], ms))
    keep = [] if final else running[-PENDING:]
    t.pending = keep
    if len(running) > len(keep):
        with _count_lock:
            stage_missed += len(running) - len(keep)


def rows() -> np.ndarray:
    """The ring's finished rows, every thread's, in call order: an (n,
    len(COLUMNS)) int64 copy."""
    a = np.frombuffer(_ring, dtype=np.int64).reshape(RING, _NCOL).copy()
    a = a[a[:, END] != 0]
    return a[np.argsort(a[:, SEQ], kind="stable")]


def variant_names() -> list:
    return list(_variants)


def stages() -> list:
    """The detailed calls' stages, in the order harvested: (seq, variant,
    {stage: ms}), this thread's pending calls harvested first (those
    still running counted missed)."""
    if _t.pending:
        _harvest(_t, final=True)
    return list(_stages)


def captures() -> list:
    """Every capture's (variant, seconds), in order."""
    return list(_captures)


def last_split() -> tuple:
    """(put, launch) seconds of this thread's last finished call: its start
    to its upload's end, and from there to its end; (0, 0) before any."""
    base = _t.last
    if base < 0:
        return 0.0, 0.0
    r = _ring
    return ((r[base + PUT] - r[base + START]) * 1e-9,
            (r[base + END] - r[base + PUT]) * 1e-9)


def reset() -> None:
    """Forget every row, stage, capture, miss and upload, and count calls
    from 0 again (tests)."""
    global stage_missed, upload_overlapped, upload_inline, _seq
    for i in range(len(_ring)):
        _ring[i] = 0
    _seq = itertools.count()
    _stages.clear()
    _captures.clear()
    stage_missed = upload_overlapped = upload_inline = 0
    _t.pending = []
