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

__all__ = ["KernelLibrary", "load"]

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
    if name in _loaded:
        return _loaded[name]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    cached = so.exists()
    seconds, log = 0.0, ""
    if not cached:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, so)
    kl = KernelLibrary(ctypes.CDLL(str(so)), so, seconds, cached, log)
    _loaded[name] = kl
    return kl
