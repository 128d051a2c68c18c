"""Ham-band allocation lookup (bandplan.c / bandplan.txt; port of
``ka9q_sdr_tpu.utils.bandplan``, host only).

Parses the reference's bandplan.txt format: ``lower upper classes modes
name`` with frequencies in MHz, ``b<bw>`` center/bandwidth shorthand
(bandplan.c:70-80), license-class letters E/A/G/T/N and emission letters
C/V/I/D.  lookup() rounds to the nearest Hz and searches in MHz
(bandplan.c:41-50) for the Info-window display.  The table ships as
``ka9q_sdr_tpu_torch/data/bandplan.txt`` (`load_default`).
"""

from __future__ import annotations

import bisect
import importlib.resources
from dataclasses import dataclass

__all__ = [
    "BandplanEntry",
    "Bandplan",
    "load_default",
    "NOVICE_CLASS",
    "TECHNICIAN_CLASS",
    "GENERAL_CLASS",
    "ADVANCED_CLASS",
    "EXTRA_CLASS",
    "VOICE",
    "DATA",
    "IMAGE",
    "CW",
]

# license classes (bandplan.h:9-13)
NOVICE_CLASS = 1
TECHNICIAN_CLASS = 2
GENERAL_CLASS = 4
ADVANCED_CLASS = 8
EXTRA_CLASS = 16
# emission types (bandplan.h:16-19)
VOICE = 1
DATA = 2
IMAGE = 4
CW = 8

_CLASS_LETTERS = {
    "e": EXTRA_CLASS,
    "a": ADVANCED_CLASS,
    "g": GENERAL_CLASS,
    "t": TECHNICIAN_CLASS,
    "n": NOVICE_CLASS,
}
_MODE_LETTERS = {"c": CW, "v": VOICE, "i": IMAGE, "d": DATA}


@dataclass
class BandplanEntry:
    lower: float   # MHz
    upper: float   # MHz
    classes: int = 0
    modes: int = 0
    name: str = ""

    @property
    def mode_names(self) -> list[str]:
        out = []
        if self.modes & CW:
            out.append("CW")
        if self.modes & DATA:
            out.append("Data")
        if self.modes & VOICE:
            out.append("Voice")
        if self.modes & IMAGE:
            out.append("Image")
        return out


class Bandplan:
    def __init__(self, entries: list[BandplanEntry]):
        self.entries = sorted(entries, key=lambda e: e.lower)
        self._lowers = [e.lower for e in self.entries]

    @classmethod
    def parse(cls, text: str) -> "Bandplan":
        """init_bandplan (bandplan.c:54-137)."""
        entries = []
        for line in text.splitlines():
            if not line or line[0] in ";#":
                continue
            fields = line.split(None, 4)
            if len(fields) < 4:
                continue
            try:
                lower = float(fields[0])
            except ValueError:
                continue
            try:
                if fields[1].startswith("b"):
                    bw = float(fields[1][1:])
                    center = lower
                    lower, upper = center - bw / 2, center + bw / 2
                else:
                    upper = float(fields[1])
            except ValueError:
                continue
            classes = 0
            for c in fields[2].lower():
                classes |= _CLASS_LETTERS.get(c, 0)
            modes = 0
            for c in fields[3].lower():
                modes |= _MODE_LETTERS.get(c, 0)
            name = fields[4].strip() if len(fields) > 4 else ""
            entries.append(BandplanEntry(lower, upper, classes, modes, name))
        return cls(entries)

    @classmethod
    def load(cls, path: str) -> "Bandplan":
        with open(path) as f:
            return cls.parse(f.read())

    def lookup(self, freq_hz: float) -> BandplanEntry | None:
        """lookup_frequency (bandplan.c:41-50): binary search in MHz."""
        key = round(freq_hz) / 1e6
        i = bisect.bisect_right(self._lowers, key)
        # scan left over possibly-overlapping segments
        for j in range(i - 1, -1, -1):
            e = self.entries[j]
            if e.lower <= key <= e.upper:
                return e
            if e.upper < key and j < i - 4:
                break
        return None


def load_default() -> Bandplan | None:
    """The table shipped with the port, or None where it cannot be read
    (the dashboards then show no band)."""
    try:
        return Bandplan.parse(
            (importlib.resources.files("ka9q_sdr_tpu_torch") / "data"
             / "bandplan.txt").read_text())
    except (OSError, ValueError):
        return None
