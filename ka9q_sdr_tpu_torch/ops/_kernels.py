"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library, then loaded with
ctypes.  The build happens at first use, never at import, and is cached in
``build/`` at the root of the checkout under the hash of its source, so an
edited source rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

__all__ = ["KernelLibrary", "load", "load_all"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float     # build time; 0.0 when a cached build was loaded
    cached: bool
    log: str           # nvcc's output (ptxas register/spill report)


_loaded: dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def load(name: str) -> KernelLibrary:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if no build of the current source exists."""
    return load_all([name])[name]


def load_all(names) -> dict[str, KernelLibrary]:
    """Load several kernel libraries; the missing builds run as concurrent
    ``nvcc`` processes, one per source."""
    todo = {}
    for name in names:
        if name in _loaded:
            continue
        src = _CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        todo[name] = (src, BUILD_DIR / f"lib{name}-{digest}.so")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, (src, so) in todo.items():
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (tmp, proc) in procs.items():   # wait for every build
        logs[name] = (proc.communicate()[0], time.perf_counter() - t0)
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {todo[name][0]}:\n"
                               f"{logs[name][0]}")
        os.replace(tmp, todo[name][1])
    for name, (src, so) in todo.items():
        log, seconds = logs.get(name, ("", 0.0))
        _loaded[name] = KernelLibrary(ctypes.CDLL(str(so)), so, seconds,
                                      name not in procs, log)
    return {name: _loaded[name] for name in names}
