"""I/Q recording and replay files (iqrecord.c / iqplay.c / attr.c).

Recordings are headerless interleaved int16 I/Q (or PCM) files whose
metadata lives in user.* extended attributes with the reference's exact
key names and printf formats (iqrecord.c:263-289): samplerate, channels,
ssrc (hex), sampleformat, frequency, source_timestamp, source, multicast,
unixstarttime.  RTP timestamp gaps become file holes via seek, so sparse
files preserve sample timing (iqrecord.c:291-302).  On filesystems
without xattr support a `<name>.attrs` sidecar with the same keys is used.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..net.rtp import (RTPHeader, RTPState, rtp_process, IQ_PT, IQ_PT8,
                       PCM_MONO_PT)

__all__ = ["write_metadata", "read_metadata", "IQRecorder", "IQReader"]


def write_metadata(path: str, attrs: dict[str, str]) -> None:
    """attrprintf-style (attr.c:55-76): each value stored as text in
    user.<key>.  Falls back to a sidecar file."""
    try:
        for k, v in attrs.items():
            os.setxattr(path, f"user.{k}", str(v).encode())
    except OSError:
        with open(path + ".attrs", "w") as f:
            for k, v in attrs.items():
                f.write(f"{k}={v}\n")


def read_metadata(path: str) -> dict[str, str]:
    """attrscanf equivalent (attr.c:22-49)."""
    out: dict[str, str] = {}
    try:
        for k in os.listxattr(path):
            if k.startswith("user."):
                out[k[5:]] = os.getxattr(path, k).decode()
        if out:
            return out
    except OSError:
        pass
    try:
        with open(path + ".attrs") as f:
            for line in f:
                if "=" in line:
                    k, v = line.rstrip("\n").split("=", 1)
                    out[k] = v
    except OSError:
        pass
    return out


@dataclass
class IQRecorder:
    """Record one RTP session to a file (iqrecord.c:153-305).

    Feed write_packet() with parsed RTP headers + payload bytes; timestamp
    gaps seek forward leaving holes.  File naming follows the reference:
    iqrecord-<freq>Hz-<ssrc> for I/Q, pcmrecord-<ssrc> for PCM."""

    directory: str = "."
    filename: Optional[str] = None
    frequency: float = 0.0
    samprate: int = 192000
    source: str = ""
    multicast: str = ""
    _fp: object = None
    _rtp_state: RTPState = field(default_factory=RTPState)

    def _open(self, rtp: RTPHeader) -> None:
        channels = 1 if rtp.type == PCM_MONO_PT else 2
        if self.filename is None:
            if rtp.type in (IQ_PT, IQ_PT8):
                self.filename = f"iqrecord-{self.frequency:.1f}Hz-{rtp.ssrc:x}"
            else:
                self.filename = f"pcmrecord-{rtp.ssrc:x}"
        path = os.path.join(self.directory, self.filename)
        self._fp = open(path, "wb")
        attrs = {
            "samplerate": str(self.samprate),
            "channels": str(channels),
            "ssrc": f"{rtp.ssrc:x}",
            "unixstarttime": f"{time.time():.6f}",
        }
        if rtp.type in (IQ_PT, IQ_PT8):
            # The reference's switch has no IQ_PT8 case (iqrecord.c:267-280
            # would leave 8-bit sessions undescribed); we extend the same
            # attr scheme so IQReader can decode the narrower samples.
            attrs["sampleformat"] = "s16le" if rtp.type == IQ_PT else "s8"
            attrs["frequency"] = f"{self.frequency:.3f}"
        else:
            attrs["sampleformat"] = "s16be"
        if self.source:
            attrs["source"] = self.source
        if self.multicast:
            attrs["multicast"] = self.multicast
        self._fp.flush()
        write_metadata(path, attrs)
        self.path = path

    @staticmethod
    def frame_bytes(ptype: int) -> int:
        """Bytes per sample frame: components x component width (the
        8-bit I/Q PT 98 carries 1-byte components, sdr.h/multicast.h)."""
        if ptype == PCM_MONO_PT:
            return 2            # 1 ch x s16
        if ptype == IQ_PT8:
            return 2            # 2 ch x s8
        return 4                # IQ s16 pairs / PCM stereo

    def write_packet(self, rtp: RTPHeader, payload: bytes) -> int:
        """Returns the number of sample frames written to disk (0 when the
        packet is dropped as a duplicate) so callers accounting recorded
        stream time count only what actually landed in the file."""
        if self._fp is None:
            self._open(rtp)
        frame = self.frame_bytes(rtp.type)
        sample_count = len(payload) // frame
        offset = rtp_process(self._rtp_state, rtp, sample_count)
        if offset < 0:
            # duplicates still get written at the right place in the
            # reference (offset seek backward); negative here means dupe
            return 0
        if offset:
            # leave a hole: sparse file preserves timing (iqrecord.c:301)
            self._fp.seek(offset * frame, os.SEEK_CUR)
        self._fp.write(payload)
        return sample_count

    def close(self) -> None:
        if self._fp:
            self._fp.close()
            self._fp = None


class IQReader:
    """Replay a recording as complex64 blocks (iqplay.c:35-108 file path).

    Reads s16le interleaved I/Q, scales to +/-1.0 full scale, yields
    fixed-size blocks (zero-padding the tail) — the hardware simulator
    that lets the whole stack run without a radio."""

    def __init__(self, path: str, samprate: Optional[int] = None):
        self.path = path
        self.attrs = read_metadata(path)
        self.samprate = samprate or int(self.attrs.get("samplerate", 192000))
        self.frequency = float(self.attrs.get("frequency", 0.0))
        self.sampleformat = self.attrs.get("sampleformat", "s16le")

    def blocks(self, block_len: int, loop: bool = False):
        if self.sampleformat == "s8":       # 8-bit I/Q (RTP PT 98)
            dtype, scale = "i1", 1.0 / 127.0
        else:
            dtype, scale = "<i2", 1.0 / 32767.0
        frame = 2 * np.dtype(dtype).itemsize
        with open(self.path, "rb") as f:
            while True:
                raw = f.read(block_len * frame)
                if not raw:
                    if loop:
                        f.seek(0)
                        continue
                    return
                x = np.frombuffer(raw, dtype).astype(np.float32) * scale
                if len(x) < block_len * 2:
                    x = np.pad(x, (0, block_len * 2 - len(x)))
                yield x[0::2] + 1j * x[1::2]
