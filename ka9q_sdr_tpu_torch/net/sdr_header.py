"""Legacy in-band status header (struct status, sdr.h:18-48).

A 24-byte HOST-endian header appended after the RTP header in every I/Q
packet from the old front ends: GPS-epoch nanosecond timestamp, LO1
frequency, sample rate and three analog gains.  Being replaced by the TLV
status stream — `radio` now skips it on receive (main.c:338-341) — but
iqplay still emits it (iqplay.c), so we keep both directions.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = ["LegacyStatus", "LEGACY_STATUS_SIZE"]

LEGACY_STATUS_SIZE = 24
# host byte order ("=" disables padding but keeps native endianness, which
# matches the reference's direct struct copy, sdr.h:15-17)
_FMT = "=qdIBBBx"


@dataclass
class LegacyStatus:
    timestamp: int = 0      # ns since GPS epoch 1980-01-06
    frequency: float = 0.0  # LO1, Hz
    samprate: int = 0
    lna_gain: int = 0
    mixer_gain: int = 0
    if_gain: int = 0

    def to_bytes(self) -> bytes:
        return struct.pack(
            _FMT,
            self.timestamp,
            self.frequency,
            self.samprate,
            self.lna_gain,
            self.mixer_gain,
            self.if_gain,
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "LegacyStatus":
        if len(data) < LEGACY_STATUS_SIZE:
            # ValueError, not struct.error: every wire-ingest loop guards
            # the net-module parsers with `except ValueError`
            raise ValueError(
                f"legacy status too short: {len(data)} < {LEGACY_STATUS_SIZE}"
            )
        t, f, sr, lna, mix, ifg = struct.unpack(_FMT, data[:LEGACY_STATUS_SIZE])
        return cls(t, f, sr, lna, mix, ifg)
