"""Demodulator mode table (reference: modes.c:32-124 and modes.txt).

A copy of ``ka9q_sdr_tpu.utils.modes`` (pure Python), so the port needs
nothing of the JAX package; tests/test_torch_ops.py holds the two tables
equal.  A mode row names a demodulator and its filter edges, post-filter
frequency shift, AGC rates and option flags.  The file format is the
reference's whitespace-separated modes.txt: ``name demod low high shift
attack recovery hang [flags...]`` with ``#`` comments.  The shipped table
reproduces the reference's modes.txt:25-39.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ModeDef", "parse_modes", "load_modes", "DEFAULT_MODES"]

_DEMODS = ("LINEAR", "AM", "FM")   # Demodtab order (modes.c:25-29)


@dataclass(frozen=True)
class ModeDef:
    """One row of the mode table (struct modetab, radio.h)."""

    name: str
    demod: str            # "FM" | "AM" | "LINEAR"
    low: float            # Hz, filter low edge
    high: float           # Hz, filter high edge
    shift: float = 0.0    # Hz, post-filter frequency shift
    attack_rate: float = 0.0     # dB/s, negative
    recovery_rate: float = 0.0   # dB/s, positive
    hangtime: float = 0.0        # s
    flat: bool = False
    isb: bool = False
    pll: bool = False
    square: bool = False
    channels: int = 2


def parse_modes(text: str) -> dict[str, ModeDef]:
    """Parse a modes.txt-format table (modes.c:41-122)."""
    out: dict[str, ModeDef] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        fields = line.split()
        if len(fields) < 8:
            continue
        name, demod_name = fields[0], fields[1].upper()
        demod = next(
            (d for d in _DEMODS if demod_name.startswith(d)), None
        )
        if demod is None:
            continue
        low, high = float(fields[2]), float(fields[3])
        if high < low:
            low, high = high, low
        shift = float(fields[4])
        attack = -abs(float(fields[5]))
        recovery = abs(float(fields[6]))
        hang = abs(float(fields[7]))
        flat = isb = pll = square = False
        channels = 2
        for opt in fields[8:]:
            o = opt.lower()
            if o in ("isb", "conj"):
                isb = True
            elif o == "flat":
                flat = True
            elif o == "square":
                square = pll = True
            elif o in ("coherent", "pll"):
                pll = True
            elif o == "mono":
                channels = 1
            elif o == "stereo":
                channels = 2
        out[name.upper()] = ModeDef(
            name=name.upper(),
            demod=demod,
            low=low,
            high=high,
            shift=shift,
            attack_rate=attack,
            recovery_rate=recovery,
            hangtime=hang,
            flat=flat,
            isb=isb,
            pll=pll,
            square=square,
            channels=channels,
        )
    return out


def load_modes(path: str) -> dict[str, ModeDef]:
    with open(path) as f:
        return parse_modes(f.read())


#: The reference's shipped mode table (modes.txt:25-39).
_DEFAULT_TABLE = """
FM    FM      -8000  +8000    0    0    0    0
FMF   FM      -8000  +8000    0    0    0    0    flat
AM    AM      -5000  +5000    0  -50  +50  0.0
CAM   LINEAR  -5000  +5000    0  -50  +50  0.0    pll mono
DSB   LINEAR  -5000  +5000    0  -50   +6  1.1    square mono
IQ    LINEAR  -5000  +5000    0  -50   +6  1.1
ISB   LINEAR  -5000  +5000    0  -50   +6  1.1    conj
CISB  LINEAR  -5000  +5000    0  -50   +6  1.1    pll conj
CWU   LINEAR   -200   +200  +700 -50  +20  0.2    mono
CWL   LINEAR   -200   +200  -700 -50  +20  0.2    mono
USB   LINEAR   +100  +3000    0  -50   +6  1.1    mono
LSB   LINEAR  -3000   -100    0  -50   +6  1.1    mono
AME   LINEAR      0  +3000    0  -50  +15  0.0    pll mono
"""

DEFAULT_MODES: dict[str, ModeDef] = parse_modes(_DEFAULT_TABLE)
