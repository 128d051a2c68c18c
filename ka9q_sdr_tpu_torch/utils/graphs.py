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

On a CUDA device each variant key is captured as a ``torch.cuda.CUDAGraph``
at its first call, as the JAX wrappers jit lazily, and replayed once per
call after that (the first call replays too).  Before the capture the step
runs once on the capture stream with its results dropped: that creates the
cuFFT plans, builds and loads the kernel libraries and makes every first
launch and allocation happen outside the capture.  The graphs of one
``StepGraphs`` share one memory pool; that is safe because the only
tensors live across replays are the state and the static inputs (allocated
outside the pool) and each replay's outputs are cloned on the same stream
before any other replay.  A capture or a replay that fails raises: nothing
falls back to the eager step.  ``capture=False``, or a CPU device, runs
the same step eagerly through the same static-state code (the eager twin
that the card's checks hold the graphs against).  Python's cyclic
collector is held off during a capture: a wrapper dropped in a reference
cycle would otherwise have its graphs torn down mid-capture.

Kernel launch counts: a kernel wrapper counts its launches as it queues
them, which a replay does not do.  The launches a capture queued are
recorded and added to the counters on every replay, while the warm-up's
and the capture's own are taken back out; so ``ops.ffill.launches`` and
``ops.agc.launches`` count the kernels that computed the blocks returned.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable, NamedTuple

import torch

__all__ = ["StepGraphs", "write_state", "clone_tree", "static_copy", "scan",
           "tree_leaves"]

#: CUDA allows one stream capture at a time in a process; the daemons that
#: share one (``chip_smoke.py`` runs several on threads) take turns here.
_CAPTURE_LOCK = threading.Lock()


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
    for i in range(xs.shape[0]):
        state, y = step(state, xs[i])
        if out is None:
            out = y.new_empty((xs.shape[0],) + tuple(y.shape))
        out[i] = y
    return state, out


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

    def clear(self) -> None:
        self.graphs.clear()
        self._pool = None           # a new pool: the old one goes with them

    def run(self, key, fn: Callable, state, inputs: tuple,
            warmup: Callable | None = None):
        """fn(state, *inputs) -> (new_state, outputs): writes new_state
        into `state`'s tensors and returns outputs the caller owns.
        `inputs` are tensors (any device; copied to this one).  `warmup`,
        where given, replaces fn for the capture's warm-up run (a scan
        warms up with one step)."""
        if not self.capture:
            new, out = fn(state, *inputs)
            write_state(state, new)
            static = {_storage(t) for t in tree_leaves(state)}
            # an output that is a state tensor changes with the next block
            return _map(lambda t: t.clone() if _storage(t) in static else t,
                        out)
        key = (key,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
        with torch.cuda.device(self.device):
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(key, fn, state, inputs, warmup)
            elif g.state_ptrs != _ptrs(state):
                raise RuntimeError(
                    "the static state was replaced since its graph was "
                    "captured; write edits into it (write_state) or clear()")
            for s, x in zip(g.inputs, inputs):
                s.copy_(x)
            g.graph.replay()
            self.replays += 1
            for m, n in zip(_counters(), g.launches):
                m.launches += n
            return clone_tree(g.outputs)

    def _capture(self, key, fn, state, inputs, warmup) -> _Graph:
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
            with torch.cuda.stream(self._stream):
                (warmup or fn)(state, *static_in)      # results dropped
            cur.wait_stream(self._stream)
            warm = _counts()
            graph = torch.cuda.CUDAGraph()
            # a collection inside the capture could free another wrapper's
            # graph, whose teardown a capture forbids: it would invalidate
            # this one
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream,
                                      capture_error_mode="thread_local"):
                    new, out = fn(state, *static_in)
                    write_state(state, new)
            finally:
                if collecting:
                    gc.enable()
            launches = tuple(a - b for a, b in zip(_counts(), warm))
            _set_counts(before)
            g = _Graph(graph, fn, static_in, out, _ptrs(state), launches)
            self.graphs[key] = g
            self.capture_s += time.perf_counter() - t0
            return g
