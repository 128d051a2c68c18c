"""RTP header marshalling and per-stream sequence/timestamp tracking.

Wire-compatible with the reference (multicast.h:26-50, multicast.c:239-340):
big-endian RTP v2 headers with the reference's non-standard payload types,
and the same resequencing semantics — duplicate drop, drop counting, and
timestamp-gap reporting for zero-fill.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = [
    "RTP_VERS",
    "RTP_MIN_SIZE",
    "IQ_PT",
    "IQ_PT8",
    "AX25_PT",
    "PCM_MONO_PT",
    "PCM_STEREO_PT",
    "OPUS_PT",
    "RTPHeader",
    "RTPState",
    "rtp_payload",
    "rtp_process",
]

RTP_VERS = 2
RTP_MIN_SIZE = 12

#: Payload types (multicast.h:19-24).
IQ_PT = 97          # raw I/Q, 16-bit
IQ_PT8 = 98         # raw I/Q, 8-bit
AX25_PT = 96        # raw AX.25 frames
PCM_MONO_PT = 11
PCM_STEREO_PT = 10
OPUS_PT = 111


@dataclass
class RTPHeader:
    """Internal representation (struct rtp_header, multicast.h:27-38)."""

    version: int = RTP_VERS
    type: int = 0
    seq: int = 0
    timestamp: int = 0
    ssrc: int = 0
    marker: bool = False
    pad: bool = False
    extension: bool = False
    csrc: tuple = ()

    def to_bytes(self) -> bytes:
        """hton_rtp (multicast.c:282-294); always writes version 2."""
        cc = len(self.csrc) & 0xF
        b0 = (RTP_VERS << 6) | (int(self.pad) << 5) | (int(self.extension) << 4) | cc
        b1 = (int(self.marker) << 7) | (self.type & 0x7F)
        out = struct.pack(
            ">BBHII",
            b0,
            b1,
            self.seq & 0xFFFF,
            self.timestamp & 0xFFFFFFFF,
            self.ssrc & 0xFFFFFFFF,
        )
        for c in self.csrc[:cc]:
            out += struct.pack(">I", c & 0xFFFFFFFF)
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> tuple["RTPHeader", int]:
        """ntoh_rtp (multicast.c:242-277).  Returns (header, payload_offset);
        any header extension is skipped."""
        if len(data) < RTP_MIN_SIZE:
            raise ValueError(f"RTP packet too short: {len(data)}")
        b0, b1, seq, timestamp, ssrc = struct.unpack(">BBHII", data[:12])
        h = cls(
            version=b0 >> 6,
            pad=bool((b0 >> 5) & 1),
            extension=bool((b0 >> 4) & 1),
            marker=bool(b1 >> 7),
            type=b1 & 0x7F,
            seq=seq,
            timestamp=timestamp,
            ssrc=ssrc,
        )
        off = 12
        cc = b0 & 0xF
        if len(data) < off + 4 * cc:
            raise ValueError("RTP packet truncated in CSRC list")
        csrc = []
        for _ in range(cc):
            csrc.append(struct.unpack(">I", data[off : off + 4])[0])
            off += 4
        h.csrc = tuple(csrc)
        if h.extension:
            off += 2  # skip type
            if len(data) < off + 2:
                raise ValueError("RTP packet truncated in extension")
            (ext_len,) = struct.unpack(">H", data[off : off + 2])
            off += 2 + 4 + ext_len  # 4 + len per multicast.c:272
            if off > len(data):
                # extension claims more bytes than the datagram holds —
                # malformed; drop rather than hand out stream state to a
                # packet with no possible payload (native engine agrees)
                raise ValueError("RTP extension length exceeds packet")
        return h, off


def rtp_payload(hdr: RTPHeader, data: bytes, off: int) -> bytes:
    """Extract the payload, stripping RTP padding (monitor.c:312-317,
    opus.c:190-194: the last pad byte holds the pad count).  Returns b""
    for a bogus pad count instead of raising — the reference's
    'if(pkt->len <= 0) continue' tolerance for hostile datagrams."""
    payload = data[off:]
    if hdr.pad and payload:
        pad = payload[-1]
        if pad == 0 or pad > len(payload):
            return b""
        payload = payload[:-pad]
    return payload


@dataclass
class RTPState:
    """Per-stream rx/tx state (struct rtp_state, multicast.h:41-50)."""

    ssrc: int = 0
    init: bool = False
    seq: int = 0
    timestamp: int = 0
    packets: int = 0
    bytes: int = 0
    drops: int = 0
    dupes: int = 0


def rtp_process(state: RTPState, rtp: RTPHeader, sampcnt: int) -> int:
    """Sequence/timestamp bookkeeping (rtp_process, multicast.c:305-340).

    Returns <0 to drop (duplicate/old), 0 if in sequence, or the timestamp
    jump (samples lost, to be zero-filled) otherwise.  An SSRC change
    resets the stream (producer restart tolerance, multicast.c:306-313).
    """
    if rtp.ssrc != state.ssrc:
        state.init = False
        state.ssrc = rtp.ssrc
    if not state.init:
        state.packets = 0
        state.seq = rtp.seq
        state.timestamp = rtp.timestamp
        state.dupes = 0
        state.drops = 0
        state.init = True
    state.packets += 1
    # int16 wraparound arithmetic on the sequence number (multicast.c:324)
    seq_step = ((rtp.seq - state.seq + 0x8000) & 0xFFFF) - 0x8000
    if seq_step != 0:
        if seq_step < 0:
            state.dupes += 1
            return -1
        state.drops += seq_step
    state.seq = (rtp.seq + 1) & 0xFFFF
    # int32 wraparound on the timestamp (multicast.c:334)
    time_step = ((rtp.timestamp - state.timestamp + 0x80000000) & 0xFFFFFFFF) - 0x80000000
    if time_step < 0:
        return time_step
    state.timestamp = (rtp.timestamp + sampcnt) & 0xFFFFFFFF
    return time_step
