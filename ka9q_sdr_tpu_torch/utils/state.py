"""Receiver state files (~/.radiostate/<name>, main.c:368-439).

Same line-oriented text format as the reference so state files are
interchangeable: Frequency/Mode/Shift/Filter low/Filter high/Blocksize/
Impulse len/Source/Output/TTL/Tunestep/Locale.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["RadioState", "state_path", "savestate", "loadstate"]


def state_path(filename: str) -> str:
    if filename.startswith("/"):
        return filename
    return os.path.join(os.path.expanduser("~/.radiostate"), filename)


@dataclass
class RadioState:
    """The ~12 persisted receiver settings (main.c:382-394)."""

    source: str = ""
    output: str = ""
    ttl: int = 1
    blocksize: int = 3840
    impulse_len: int = 4353
    frequency: float = 0.0
    mode: str = "FM"
    shift: float = 0.0
    filter_low: float = float("nan")
    filter_high: float = float("nan")
    kaiser_beta: float = 3.0
    tunestep: int = 0
    locale: str = ""


def savestate(st: RadioState, filename: str) -> None:
    """savestate (main.c:370-396)."""
    path = state_path(filename)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fp:
        fp.write("#KA9Q DSP Receiver State dump\n")
        if st.locale:
            fp.write(f"Locale {st.locale}\n")
        fp.write(f"Source {st.source}\n")
        fp.write(f"Output {st.output}\n")
        fp.write(f"TTL {st.ttl}\n")
        fp.write(f"Blocksize {st.blocksize}\n")
        fp.write(f"Impulse len {st.impulse_len}\n")
        fp.write(f"Frequency {st.frequency:.3f} Hz\n")
        fp.write(f"Mode {st.mode}\n")
        fp.write(f"Shift {st.shift:.3f} Hz\n")
        fp.write(f"Filter low {st.filter_low:.3f} Hz\n")
        fp.write(f"Filter high {st.filter_high:.3f} Hz\n")
        fp.write(f"Tunestep {st.tunestep}\n")


def loadstate(filename: str, st: RadioState | None = None) -> RadioState:
    """loadstate (main.c:402-439); unknown lines ignored."""
    st = st or RadioState()
    path = state_path(filename)
    with open(path) as fp:
        for line in fp:
            line = line.rstrip("\n")
            try:
                if line.startswith("Frequency "):
                    st.frequency = float(line.split()[1])
                elif line.startswith("Mode "):
                    st.mode = line[5:].strip()
                elif line.startswith("Shift "):
                    st.shift = float(line.split()[1])
                elif line.startswith("Filter low "):
                    st.filter_low = float(line.split()[2])
                elif line.startswith("Filter high "):
                    st.filter_high = float(line.split()[2])
                elif line.startswith("Kaiser Beta "):
                    st.kaiser_beta = float(line.split()[2])
                elif line.startswith("Blocksize "):
                    st.blocksize = int(line.split()[1])
                elif line.startswith("Impulse len "):
                    st.impulse_len = int(line.split()[2])
                elif line.startswith("Tunestep "):
                    st.tunestep = int(line.split()[1])
                elif line.startswith("Source "):
                    st.source = line.split()[1]
                elif line.startswith("Output "):
                    st.output = line.split()[1]
                elif line.startswith("TTL "):
                    st.ttl = int(line.split()[1])
                elif line.startswith("Locale "):
                    st.locale = line.split()[1]
            except (ValueError, IndexError):
                continue
    return st
