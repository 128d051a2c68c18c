"""Carry bank/demod/oscillator state between the JAX package and the port.

The bank has no weights; what the two implementations share is state.  The
JAX package's state is a tree of NamedTuples (BankState, FMState, OscState);
map it to numpy leaves (``jax.tree_util.tree_map(np.asarray, state)``) and
``state_from_jax`` builds the port's tree of the same names on a device.
``state_to_numpy`` goes back.  The uint32 phase/frequency words become int64
in the port and uint32 again on the way back; complex64 stays complex64.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bank import BankState
from .models.demod_fm import FMState
from .ops.nco import OscState

__all__ = ["state_from_jax", "state_to_numpy"]

_PORT = {cls.__name__: cls for cls in (BankState, FMState, OscState)}
_U32_FIELDS = {("OscState", "phase"), ("OscState", "freq")}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_from_jax(tree, *, device):
    """JAX-package state with numpy leaves -> the port's state on `device`."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        cls = _PORT[type(tree).__name__]
        return cls(*(state_from_jax(x, device=device) for x in tree))
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def state_to_numpy(state):
    """The port's state -> the same NamedTuples with numpy leaves, in the
    JAX package's dtypes."""
    if state is None:
        return None
    if _is_namedtuple(state):
        name = type(state).__name__
        return type(state)(*(
            state_to_numpy(x).astype(np.uint32)
            if (name, field) in _U32_FIELDS else state_to_numpy(x)
            for field, x in zip(state._fields, state)
        ))
    return state.detach().cpu().numpy()
