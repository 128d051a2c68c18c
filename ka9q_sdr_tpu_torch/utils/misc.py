"""Small host-side helpers (reference: misc.h macros, display.c:1089-1132).
"""

from __future__ import annotations

import math

__all__ = [
    "parse_frequency",
    "db2voltage",
    "voltage2db",
    "power2db",
    "db2power",
    "set_locale",
    "audio_device_notice",
    "GPS_UTC_OFFSET",
    "UNIX_EPOCH_GPS",
]


def audio_device_notice(prog: str, list_audio: bool, audiodev: str | None,
                        role: str, sink: str) -> bool:
    """Shared handling of the reference's portaudio -L/-I/-R device flags
    (pcmsend.c/opussend.c -I -L, monitor.c -R -L) for a target with no
    audio hardware: -L lists nothing and explains the stdin/stdout sink,
    a named device prints a notice and falls back to it.  Returns True
    when -L was handled (caller exits 0)."""
    import sys
    if list_audio:
        print(f"no audio {role} devices in this target; {sink}",
              file=sys.stderr)
        return True
    if audiodev:
        print(f"{prog}: audio {role} device {audiodev!r} n/a in this "
              f"target; {sink}", file=sys.stderr)
    return False


def set_locale(name: str | None) -> None:
    """Best-effort setlocale for the daemons' reference -l flag
    (main.c:150-153, iqplay.c:143, iqrecord.c): the reference uses it
    only for numeric display formatting, so an unknown locale is not an
    error."""
    if not name:
        return
    import locale
    try:
        locale.setlocale(locale.LC_ALL, name)
    except locale.Error:
        pass

#: GPS-UTC leap second offset and GPS epoch in UNIX time (sdr.h timestamp
#: convention: nanoseconds since GPS epoch 1980-01-06).
GPS_UTC_OFFSET = 18
UNIX_EPOCH_GPS = 315964800


def db2voltage(db: float) -> float:
    return 10.0 ** (db / 20.0)


def voltage2db(v: float) -> float:
    return 20.0 * math.log10(v)


def db2power(db: float) -> float:
    return 10.0 ** (db / 10.0)


def power2db(p: float) -> float:
    return 10.0 * math.log10(p)


def parse_frequency(s: str) -> float:
    """Parse a frequency entry (display.c:1089-1132).

    ``12345`` = 12345 Hz; ``12k345`` = 12.345 kHz; ``12m345`` = 12.345 MHz;
    ``12g345`` = 12.345 GHz.  Without a suffix, small numbers get a
    heuristic kHz/MHz guess assuming 100 kHz - 2 GHz coverage.

    The heuristic applies to the MAGNITUDE: bank channels are baseband
    offsets that are legitimately negative (``-200000`` = -200 kHz,
    ``-50`` = -50 MHz), a case display.c never sees; comparing the
    signed value would shunt every negative entry into the x1e6 branch.
    """
    ss = s.lower()
    mult = 1.0
    for letter, m in (("g", 1e9), ("m", 1e6), ("k", 1e3)):
        if letter in ss:
            ss = ss.replace(letter, ".", 1)
            mult = m
            break
    try:
        # strtod-style: parse the leading numeric prefix
        for end in range(len(ss), 0, -1):
            try:
                f = float(ss[:end])
                break
            except ValueError:
                continue
        else:
            return 0.0
    except ValueError:
        return 0.0
    if f == 0:
        return 0.0
    sign, f = (-1.0, -f) if f < 0 else (1.0, f)
    if mult != 1.0 or f >= 1e5:
        return sign * f * mult
    if f < 100:
        return sign * f * 1e6
    if f < 500:
        return sign * f * 1e6
    if f < 2000:
        return sign * f * 1e3
    if f < 100000:
        return sign * f * 1e3
    return sign * f
