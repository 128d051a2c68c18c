"""Device choice and device-to-host copies shared by the port's daemons
(the torch twin of the JAX package's ``configure_jax``)."""

from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = ["configure_torch", "HostCopy"]


class HostCopy:
    """One block's outputs on their way to the host.

    The constructor starts a ``non_blocking`` copy of each CUDA tensor into
    pinned host memory and records an event behind them on the current
    stream of each device they come from (a mesh's outputs may lie on
    several cards); ``wait()`` waits on those events only and returns numpy
    arrays.  CPU tensors are taken as they are.  Holding the source tensors
    until then is safe because every step of the port returns fresh
    tensors; a step that reused its output buffers (a captured CUDA graph)
    would have to copy them out before the next replay."""

    def __init__(self, tensors):
        self._host = []
        devices = []
        for t in tensors:
            if t is not None and t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                if t.device not in devices:
                    devices.append(t.device)
                t = h
            self._host.append(t)
        self._events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self._events.append(ev)

    def wait(self) -> list[np.ndarray | None]:
        for ev in self._events:
            ev.synchronize()
        return [None if h is None else h.numpy() for h in self._host]


def configure_torch(cpu: bool = False, prog: str = "ka9q") -> torch.device:
    """The device a daemon runs on: the first CUDA card, or the CPU when
    `cpu` (the daemons' --cpu).  Without a CUDA device and without `cpu`
    it exits with a message and status 2: a daemon never falls back to the
    CPU quietly."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; run on a GPU, or pass --cpu to run "
              "on the host CPU", file=sys.stderr, flush=True)
        raise SystemExit(2)
    return torch.device("cuda")
