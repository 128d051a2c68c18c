"""Compiled per-block steps: the port's counterpart of the JAX package's
``jax.jit`` around a step, and of ``lax.scan`` over blocks.

A step is a pure function ``fn(state, *inputs) -> (new_state, outputs)``
over trees of tensors (NamedTuples, tuples, lists, dicts; None and other
non-tensor leaves pass through).  A ``StepGraphs`` runs such steps over
one wrapper's static buffers:

- the state is the wrapper's own tensors: every call writes ``new_state``
  into them with ``copy_`` (inside the graph on a card), so a live edit
  between blocks must write into them too (``write_state``);
- each input is copied into a static tensor of its variant before a
  replay;
- the outputs are the graph's own buffers, which the next replay
  overwrites, so each call returns clones: a caller may hold what a call
  returned across any number of later blocks.

A wrapper that captures uploads a host block in page-locked memory on a
copy stream of its own, into one staging buffer per input shape and dtype
(``upload``), while the card still runs the block before: two events
order it, ``free`` (the stagein copy of the block before has read the
buffer) before the copy and ``ready`` after it, which the compute stream
waits on.  The host waits on neither.

On a CUDA device each variant key is captured as a ``torch.cuda.CUDAGraph``
at its first call, as the JAX wrappers jit lazily, and replayed once per
call after that (the first call replays too).  Before the capture the step
runs once on the capture stream with its results dropped: that creates the
cuFFT plans, builds and loads the kernel libraries and makes every first
launch and allocation happen outside the capture.  A ``cond`` in the step
(the port's ``lax.cond``) runs both of its branches in that warm-up and
becomes a conditional node of the graph, which the device resolves on
each replay.  The graphs of one
``StepGraphs`` share one memory pool; that is safe because the only
tensors live across replays are the state and the static inputs (allocated
outside the pool), each replay's outputs are cloned on the same stream
before any other replay, and a chain link's own outputs stay allocated
(no later capture reuses them) and are read only in the order
``MeshGraphs`` queues.  A capture or a replay that fails raises: nothing
falls back to the eager step.  ``capture=False``, or a CPU device, runs
the same step eagerly through the same static-state code (the eager twin
that the card's checks hold the graphs against).  Python's cyclic
collector is held off during a capture: a wrapper dropped in a reference
cycle would otherwise have its graphs torn down mid-capture.

A step whose shards exchange data within a block (the distributed master
FFT of a mesh bank) is a chain of per-device graphs (``MeshGraphs``): each
link is one device's graph, the next link reads its outputs in place
(``fetch``: a memcpy node in the reading graph where the devices differ),
and events queued on the devices order the links; the host waits on
none.

The port's tracer (``utils.trace``) reads a run here: each call stamps
the end of the static-input copy and the replay's launch in the calling
entry's row, a capture records its seconds (``trace.captured``), a
captured step's stage marks become kernel nodes of its graph that stamp
the device's clock (``_Graph.marks``), closed after the state
write-back, and a scan's steps carry none.

Kernel launch counts: a kernel wrapper counts its launches as it queues
them, which a replay does not do.  The launches a capture queued are
recorded and added to the counters on every replay, while the warm-up's
and the capture's own are taken back out; so ``ops.ffill.launches`` and
``ops.agc.launches`` count the kernels that computed the blocks returned.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import trace

__all__ = ["StepGraphs", "MeshGraphs", "write_state", "clone_tree",
           "static_copy", "scan", "cond", "fetch", "tree_leaves"]

#: CUDA allows one stream capture at a time in a process; the daemons that
#: share one (``chip_smoke.py`` runs several on threads) take turns here.
_CAPTURE_LOCK = threading.Lock()

#: ``ctx``: the ``_Capture`` that ``StepGraphs._capture`` runs on this
#: thread (its warm-up, then its capture), which ``cond`` reads
_CAPTURE = threading.local()


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in tree_leaves(sub)]
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    return []


def _map(fn, tree):
    """fn on every tensor leaf of a tree, keeping its structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        out = [_map(fn, t) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, list):
        return [_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def clone_tree(tree):
    """A copy of every tensor of a tree.  A tensor that appears at several
    leaves (a MultiBank's shared overlap) stays one tensor in the copy."""
    memo: dict[int, torch.Tensor] = {}

    def clone(t):
        if id(t) not in memo:
            memo[id(t)] = t.clone()
        return memo[id(t)]

    return _map(clone, tree)


def static_copy(tree):
    """A copy of a tree with every leaf its own contiguous tensor (a fresh
    state shares tensors between leaves, e.g. ``receiver_init``'s two
    oscillators; static buffers written in place must not)."""
    return _map(lambda t: t.clone(memory_format=torch.contiguous_format),
                tree)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def write_state(dst, src) -> None:
    """Write the tensors of `src` into those of `dst` (the same structure)
    in place.  Leaves that are already the destination are skipped; a
    destination that appears at several leaves is written once (every
    `src` leaf for it must hold the same value); a source that shares
    memory with a destination is copied out first, so the order of the
    writes never matters."""
    dl, sl = tree_leaves(dst), tree_leaves(src)
    if len(dl) != len(sl):
        raise ValueError(f"state has {len(sl)} tensors, the static state "
                         f"{len(dl)}")
    static = {_storage(d) for d in dl}
    pairs, seen = [], set()
    for d, s in zip(dl, sl):
        if d is s or id(d) in seen:
            continue
        seen.add(id(d))
        if d.shape != s.shape:
            raise ValueError(f"state tensor of shape {tuple(s.shape)} "
                             f"for a static {tuple(d.shape)}")
        pairs.append((d, s.clone() if _storage(s) in static else s))
    for d, s in pairs:
        d.copy_(s)


def scan(step: Callable, state, xs: torch.Tensor):
    """``lax.scan`` over the leading axis of `xs`: step(state, x) ->
    (state, y) in order; returns (final state, the ys stacked)."""
    if xs.shape[0] == 0:
        raise ValueError("a scan needs at least one block")
    out = None
    with trace.unmarked():                  # a block's stages, not k's
        for i in range(xs.shape[0]):
            state, y = step(state, xs[i])
            if out is None:
                out = y.new_empty((xs.shape[0],) + tuple(y.shape))
            out[i] = y
    return state, out


def _zip_map(fn, a, b):
    """fn(x, y) on the tensor leaves of two trees of one structure."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, tuple):
        out = [_zip_map(fn, x, y) for x, y in zip(a, b)]
        return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return a


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
         *operands):
    """``lax.cond``: true_fn(*operands) where the 0-d bool `pred` holds,
    else false_fn(*operands); both return trees of one structure, shapes
    and dtypes.

    - On the CPU: a Python ``if``, as ``lax.cond`` runs there.
    - On a card, inside a ``StepGraphs`` capture: an IF node of the graph
      on the device value of `pred` (``csrc/cond.cu``), so a replay runs
      true_fn's kernels only where it holds and the host never reads it.
      The outputs are a copy of false_fn's, made before the node (both of
      the port's gates return the carried state there); the node runs
      true_fn and copies its results over them.  Needs CUDA 12.4 (runtime
      and driver).  No hand kernel may launch inside true_fn: a replay
      adds its capture's launches to the counters whether or not the node
      ran, so one inside the node would be over-counted (this raises).
    - On a card, during a capture's warm-up run: both branches, selected
      with ``torch.where``, so true_fn's cuFFT plans and first allocations
      are made outside the capture whichever way the warm-up block goes.
    - On a card, eager (``capture=False``): `pred` is read on the host, one
      synchronisation per call."""
    if pred.dim() != 0 or pred.dtype != torch.bool:
        raise ValueError(f"cond needs a 0-d bool predicate, not "
                         f"{tuple(pred.shape)} {pred.dtype}")
    cap = getattr(_CAPTURE, "ctx", None)
    if pred.device.type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            return _cond_node(cap, pred, true_fn, false_fn, operands)
        if cap is not None:                         # the warm-up
            _cond_lib(cap.device)       # its module loads outside a capture
            return _zip_map(lambda t, f: torch.where(pred, t, f),
                            true_fn(*operands), false_fn(*operands))
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


class _Capture:
    """A ``StepGraphs`` capture in progress on this thread."""

    def __init__(self, device: int, pool, body):
        self.device = device
        self.pool = pool            # the graph's private memory pool
        self.body = body            # the stream IF bodies are captured on
        self.routed = False         # this thread's allocations -> pool


_COND_READY: set = set()


def _cond_lib(device: int):
    """csrc/cond.cu, loaded, with its kernel's module loaded on `device`."""
    from ..ops import _kernels

    lib = _kernels.load("cond").lib
    if lib.cond_if_begin.argtypes is None:
        lib.cond_if_begin.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.cond_if_end.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.graph_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.graph_copy.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_void_p]
        lib.graph_stamp.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
        lib.cond_error.restype = ctypes.c_char_p
    if device not in _COND_READY:
        _cond_check(lib, lib.cond_init(device), "loading the IF-node kernel")
        _COND_READY.add(device)
    return lib


def _cond_check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"cond: {what} failed: "
                           f"{lib.cond_error(err).decode()} ({err})")


def _cond_node(cap, pred, true_fn, false_fn, operands):
    """cond inside `cap`: one IF node on `pred`.  (PyTorch's own pattern,
    torch/_higher_order_ops/cudagraph_conditional_nodes.py, pairs two IF
    nodes for an else branch; a false branch that computes nothing needs
    no node.)"""
    if cap is None:
        raise RuntimeError("cond inside a stream capture needs StepGraphs "
                           "to run the capture")
    lib = _cond_lib(cap.device)
    out = clone_tree(false_fn(*operands))
    if not cap.routed:
        # the graph routes to its pool only what its own capture allocates,
        # and a body is a capture of its own: route the thread instead
        # (the graph's capture_end ends this routing)
        torch._C._cuda_endAllocateToPool(cap.device, cap.pool)
        torch._C._cuda_beginAllocateCurrentThreadToPool(cap.device, cap.pool)
        torch._C._cuda_releasePool(cap.device, cap.pool)   # one use, not two
        cap.routed = True
    before = _counts()
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    _cond_check(lib, lib.cond_if_begin(cap.device, stream, pred.data_ptr(),
                                       cap.body.cuda_stream), "an IF node")
    try:
        with torch.cuda.stream(cap.body):
            _zip_map(lambda o, r: o.copy_(r), out, true_fn(*operands))
    finally:
        _cond_check(lib, lib.cond_if_end(cap.device, cap.body.cuda_stream),
                    "the IF body's capture")
    if _counts() != before:
        raise RuntimeError("a hand kernel launched inside a conditional "
                           "node would be counted on every replay")
    return out


def fetch(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`: `t` itself where it lives there, else a copy.

    Inside a capture on `device` the copy is a memcpy node of that graph
    on the capturing stream, from `t`'s address (another graph's output,
    which stays put); torch's cross-device copy would queue on `t`'s
    device's stream, outside the capture.  The card must have peer access
    to `t`'s (``MeshGraphs`` enables it).  Elsewhere ``t.to(device)``."""
    device = _indexed(device)
    if t.device == device:
        return t
    if not (device.type == "cuda" and t.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        return t.to(device)
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    _copy_node(out, t)
    return out


def _indexed(device) -> torch.device:
    """`device` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _copy_node(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Queue a copy of `src` into `dst` (contiguous, one size, any cards)
    on dst's card's current stream: a memcpy node where it captures."""
    if not (src.is_contiguous() and dst.is_contiguous()
            and src.nbytes == dst.nbytes):
        raise ValueError("a copy node needs two contiguous tensors of one "
                         "size")
    dev = dst.device.index
    lib = _cond_lib(dev)
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    _cond_check(lib, lib.graph_copy(dev, dst.data_ptr(), src.data_ptr(),
                                    src.nbytes, stream), "a peer copy")


def _counters() -> tuple:
    from ..ops import agc, ffill, pstock

    return (ffill, agc, pstock)


def _counts() -> tuple[int, ...]:
    return tuple(m.launches for m in _counters())


def _set_counts(counts) -> None:
    for m, n in zip(_counters(), counts):
        m.launches = n


def _ptrs(tree) -> tuple[int, ...]:
    return tuple(t.data_ptr() for t in tree_leaves(tree))


class _Graph(NamedTuple):
    graph: object           # torch.cuda.CUDAGraph
    fn: Callable            # the step captured (keeps its constants alive)
    inputs: tuple           # static input tensors
    outputs: object         # the graph's output tree
    state_ptrs: tuple       # the state it was captured against
    launches: tuple         # kernel launches per replay, per counter
    marks: object           # its stage marks (trace.Stamps), or None


class _Staging(NamedTuple):
    buf: torch.Tensor       # the device copy of the last block uploaded
    ready: object           # torch.cuda.Event: on the copy stream, after it
    free: object            # on the compute stream, after its stagein


class StepGraphs:
    """The compiled steps of one host wrapper on one device.

    `run(key, fn, state, inputs)` runs the variant `key` of a step over the
    static `state`: captured and replayed on a CUDA device with `capture`
    (the default), eager otherwise.  `clear()` drops every graph, for a
    change of the configuration the steps were captured with (their
    Python constants, such as the FM audio gain, are baked in)."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.graphs: dict = {}
        self.replays = 0            # graph replays so far
        self.capture_s = 0.0        # warm-up + capture time so far
        self._pool = None
        self._stream = None
        self._body = None           # the stream cond's IF bodies capture on
        self._copy = None           # the stream uploads copy on
        self._copy_lib = None       # csrc/cond.cu, whose graph_copy they use
        self._staging: dict = {}    # (shape, dtype) -> _Staging
        self._unread: dict = {}     # those staged since the last stagein

    def clear(self) -> None:
        self.graphs.clear()
        self._pool = None           # a new pool: the old one goes with them

    def upload(self, x, dtype=None) -> torch.Tensor | None:
        """`x` (a host tensor or array) on this device without the host
        waiting: copied on the copy stream into the staging buffer of its
        shape and dtype once the stagein of the block before has read it,
        and the current stream made to wait for the copy.  None, with
        nothing queued, unless the wrapper captures and `x` is contiguous,
        of `dtype` (where given) and in page-locked memory.

        The card may still be reading `x` when this returns: the caller
        may rewrite its memory once an event recorded on the current
        stream after the entry call has completed."""
        if not self.capture:
            return None
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                return None
            src = x
        elif isinstance(x, np.ndarray):
            src = torch.as_tensor(x)
        else:
            return None
        if (dtype is not None and src.dtype != dtype) \
                or not src.is_contiguous() or not src.is_pinned():
            return None
        key = (tuple(src.shape), src.dtype)
        st = self._staging.get(key)
        if st is None:
            if self._copy is None:
                self._copy = torch.cuda.Stream(self.device)
                self._copy_lib = _cond_lib(self._copy.device_index)
            buf = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            buf.record_stream(self._copy)
            st = self._staging[key] = _Staging(buf, torch.cuda.Event(),
                                               torch.cuda.Event())
        copy, lib = self._copy, self._copy_lib
        copy.wait_event(st.free)
        tok = trace.span("put", self.device, "upload", stream=copy)
        # one cudaMemcpyAsync on the copy stream, not torch's copy_ (which
        # queues on the current stream) inside a switch of streams
        _cond_check(lib, lib.graph_copy(copy.device_index, st.buf.data_ptr(),
                                        src.data_ptr(), src.nbytes,
                                        copy.cuda_stream), "an upload")
        st.ready.record(copy)
        torch.cuda.current_stream(self.device).wait_event(st.ready)
        trace.put_done(tok)
        self._unread[key] = st
        return st.buf

    def run(self, key, fn: Callable, state, inputs: tuple,
            warmup: Callable | None = None, *, fixed=None,
            own: bool = False):
        """fn(state, *inputs) -> (new_state, outputs): writes new_state
        into `state`'s tensors and returns outputs the caller owns.
        `inputs` are tensors (any device; copied to this one).  `warmup`,
        where given, replaces fn for the capture's warm-up run (a scan
        warms up with one step).

        A link of a chain (``MeshGraphs``): `fixed`, where given, is a
        tree of tensors at fixed addresses (earlier links' outputs) passed
        as fn's last argument and read in place, not copied; a graph is
        captured for each set of their addresses.  `own` returns the
        graph's own output buffers, which the next replay overwrites,
        instead of clones."""
        extra = () if fixed is None else (fixed,)
        if not self.capture:
            tok = trace.span("replay")
            new, out = fn(state, *inputs, *extra)
            write_state(state, new)
            trace.close_marks(self.device)
            trace.replayed(tok, None)
            if own:
                return out
            tok = trace.span("clone", self.device, "clone")
            static = {_storage(t) for t in tree_leaves(state)}
            # an output that is a state tensor changes with the next block
            out = _map(lambda t: t.clone() if _storage(t) in static else t,
                       out)
            trace.close(tok)
            return out
        key = (key,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
        if fixed is not None:
            key += (_ptrs(fixed),)
        with torch.cuda.device(self.device):
            g = self.graphs.get(key)
            if g is None:
                tok = trace.span("capture")
                g = self._capture(key, fn, state, inputs, warmup, extra)
                trace.close(tok)
            elif g.state_ptrs != _ptrs(state):
                raise RuntimeError(
                    "the static state was replaced since its graph was "
                    "captured; write edits into it (write_state) or clear()")
            tok = trace.span("stagein", self.device, "stagein")
            for s, x in zip(g.inputs, inputs):
                s.copy_(x)
            if self._unread:
                cur = torch.cuda.current_stream(self.device)
                for st in self._unread.values():
                    st.free.record(cur)
                self._unread.clear()
            trace.close(tok, trace.STAGEIN)
            tok = trace.span("replay")
            g.graph.replay()
            trace.replayed(tok, g.marks)
            self.replays += 1
            for m, n in zip(_counters(), g.launches):
                m.launches += n
            if own:
                return g.outputs
            tok = trace.span("clone", self.device, "clone")
            out = clone_tree(g.outputs)
            trace.close(tok)
            return out

    def _capture(self, key, fn, state, inputs, warmup, extra) -> _Graph:
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            static_in = tuple(
                torch.empty(x.shape, dtype=x.dtype, device=self.device)
                for x in inputs)
            for s, x in zip(static_in, inputs):
                s.copy_(x)
            before = _counts()
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            if self._body is None:
                self._body = torch.cuda.Stream(self.device)
            _CAPTURE.ctx = _Capture(torch.cuda.current_device(), self._pool,
                                    self._body)
            trace.capture_marks(_indexed(self.device))
            try:
                with torch.cuda.stream(self._stream):
                    (warmup or fn)(state, *static_in, *extra)  # dropped
                cur.wait_stream(self._stream)
                warm = _counts()
                graph = torch.cuda.CUDAGraph()
                # a collection inside the capture could free another
                # wrapper's graph, whose teardown a capture forbids: it
                # would invalidate this one
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self._pool,
                                          stream=self._stream,
                                          capture_error_mode="thread_local"):
                        new, out = fn(state, *static_in, *extra)
                        write_state(state, new)
                        trace.close_marks(self.device)
                finally:
                    if collecting:
                        gc.enable()
            finally:
                _CAPTURE.ctx = None
                marks = trace.capture_end()
            launches = tuple(a - b for a, b in zip(_counts(), warm))
            _set_counts(before)
            g = _Graph(graph, fn, static_in, out, _ptrs(state), launches,
                       marks)
            self.graphs[key] = g
            dt = time.perf_counter() - t0
            self.capture_s += dt
            trace.captured(repr(key[0]), dt)
            return g


class MeshGraphs:
    """The compiled steps of one host wrapper over a mesh: one
    ``StepGraphs`` a shard (`shards`, each with its own pool and static
    buffers), and ``chain`` for a step whose shards exchange data within
    a block.

    A chain is a list of links.  Link i of shard d is a step on d's device
    alone, one graph of d's ``StepGraphs``: link 0 reads the shard's input
    (copied into a static tensor), link i > 0 every shard's outputs of
    link i - 1 in place (the producing graphs' own buffers), bringing what
    it needs onto its device with ``fetch``.  A graph never spans devices,
    so each one's allocations land in its own device's pool.  On a card,
    events on the devices' current streams order the links, and the host
    waits on none of them:

    - link i > 0 of a shard waits for link i - 1 of every shard;
    - link 0 of a block waits for the last link of every shard in the
      block before, so no device overwrites a buffer (an output, or a
      temporary that its pool gives a later capture) that another device
      may still be reading (``fence`` queues the same wait for other
      steps of the shards).

    On the CPU, or with `capture` off, the links run eagerly in the same
    order."""

    def __init__(self, devices, capture: bool = True):
        self.shards = [StepGraphs(d, capture) for d in devices]
        self._events: dict = {}     # (link, shard) -> torch.cuda.Event
        self._last: list = []       # the last link's events, last chain
        self._peers = False

    def clear(self) -> None:
        for g in self.shards:
            g.clear()

    def _wait(self, g: StepGraphs, events) -> None:
        if g.device.type == "cuda":
            stream = torch.cuda.current_stream(g.device)
            for e in events:
                stream.wait_event(e)

    def fence(self) -> None:
        """Queue on every shard's device a wait for the last link of the
        last chain on every shard."""
        for g in self.shards:
            self._wait(g, self._last)

    def _enable_peers(self) -> None:
        """Peer access between every two cards of the mesh, before any
        capture that reads another card's memory."""
        cards = sorted({_indexed(g.device).index for g in self.shards
                        if g.capture})
        for a in cards:
            lib = _cond_lib(a)
            for b in cards:
                if a != b:
                    _cond_check(lib, lib.graph_peer(a, b),
                                f"peer access from cuda:{a} to cuda:{b}")
        self._peers = True

    def chain(self, key, links, states, inputs) -> list:
        """One step over every shard as len(links) links: links[i](d) is
        shard d's fn for link i, fn(states[d], inputs[d]) for link 0 and
        fn(states[d], outs) after it, where outs[p] is what link i - 1
        returned on shard p; each returns (new_state, outputs).  Returns
        the last link's outputs of every shard, which the caller owns."""
        if not self._peers:
            self._enable_peers()
        waits = self._last
        outs = None
        for i, link in enumerate(links):
            last = i == len(links) - 1
            done = []
            for d, g in enumerate(self.shards):
                self._wait(g, waits)
                args = dict(fixed=outs) if i else {}
                done.append(g.run((key, i), link(d), states[d],
                                  () if i else (inputs[d],), own=not last,
                                  **args))
                if g.device.type == "cuda":
                    ev = self._events.setdefault((i, d), torch.cuda.Event())
                    ev.record(torch.cuda.current_stream(g.device))
            waits = [self._events[(i, d)] for d, g in enumerate(self.shards)
                     if g.device.type == "cuda"]
            outs = done
        self._last = waits
        return outs
