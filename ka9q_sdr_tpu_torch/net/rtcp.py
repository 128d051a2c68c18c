"""RTCP sender/receiver reports, source descriptions and BYE.

Wire-compatible with the reference (rtcp.c): RTP v2 control packets in
network byte order; `radio` multicasts SR+SDES once per second on the data
port + 1 (main.c:442-513).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = [
    "RTCPSenderReport",
    "RTCPReceiverReport",
    "SDESItem",
    "SDESType",
    "gen_sr",
    "gen_rr",
    "gen_sdes",
    "gen_bye",
    "NTP_EPOCH",
]

NTP_EPOCH = 2208988800  # seconds between 1900 and 1970 (multicast.h:13)


class SDESType:
    """enum sdes_type (multicast.h:73-82)."""

    CNAME = 1
    NAME = 2
    EMAIL = 3
    PHONE = 4
    LOC = 5
    TOOL = 6
    NOTE = 7
    PRIV = 8


@dataclass
class RTCPSenderReport:
    """struct rtcp_sr (multicast.h:53-59)."""

    ssrc: int = 0
    ntp_timestamp: int = 0  # 64-bit NTP format
    rtp_timestamp: int = 0
    packet_count: int = 0
    byte_count: int = 0


@dataclass
class RTCPReceiverReport:
    """struct rtcp_rr (multicast.h:62-70)."""

    ssrc: int = 0
    lost_fract: int = 0
    lost_packets: int = 0
    highest_seq: int = 0
    jitter: int = 0
    lsr: int = 0
    dlsr: int = 0


@dataclass
class SDESItem:
    """struct rtcp_sdes (multicast.h:85-90)."""

    type: int = SDESType.CNAME
    message: bytes = b""


def _rr_block(rr: RTCPReceiverReport) -> bytes:
    return (
        struct.pack(">I", rr.ssrc & 0xFFFFFFFF)
        + bytes([rr.lost_fract & 0xFF])
        + (rr.lost_packets & 0xFFFFFF).to_bytes(3, "big")
        + struct.pack(
            ">IIII",
            rr.highest_seq & 0xFFFFFFFF,
            rr.jitter & 0xFFFFFFFF,
            rr.lsr & 0xFFFFFFFF,
            rr.dlsr & 0xFFFFFFFF,
        )
    )


def gen_sr(sr: RTCPSenderReport, rrs: list[RTCPReceiverReport] = ()) -> bytes:
    """Sender report (gen_sr, rtcp.c:10-42)."""
    rc = len(rrs)
    if not 0 <= rc <= 31:
        # the count lives in a 5-bit field; 32 would overflow into the
        # padding bit and corrupt the header (the C has the same check)
        raise ValueError("0..31 receiver reports")
    words = 1 + 6 + 6 * rc
    out = bytearray()
    out.append((2 << 6) | rc)
    out.append(200)
    out += struct.pack(">H", words - 1)
    out += struct.pack(
        ">IIIIII",
        sr.ssrc & 0xFFFFFFFF,
        (sr.ntp_timestamp >> 32) & 0xFFFFFFFF,
        sr.ntp_timestamp & 0xFFFFFFFF,
        sr.rtp_timestamp & 0xFFFFFFFF,
        sr.packet_count & 0xFFFFFFFF,
        sr.byte_count & 0xFFFFFFFF,
    )
    for rr in rrs:
        out += _rr_block(rr)
    return bytes(out)


def gen_rr(ssrc: int, rrs: list[RTCPReceiverReport] = ()) -> bytes:
    """Receiver report (gen_rr, rtcp.c:45-70)."""
    rc = len(rrs)
    if not 0 <= rc <= 31:
        raise ValueError("0..31 receiver reports")
    words = 2 + 6 * rc
    out = bytearray()
    out.append((2 << 6) | rc)
    out.append(201)
    out += struct.pack(">H", words - 1)
    out += struct.pack(">I", ssrc & 0xFFFFFFFF)
    for rr in rrs:
        out += _rr_block(rr)
    return bytes(out)


def gen_sdes(ssrc: int, items: list[SDESItem]) -> bytes:
    """Source description, one chunk (gen_sdes, rtcp.c:75-109);
    zero-padded to a 4-byte boundary."""
    if not 0 <= len(items) <= 31:
        raise ValueError("0..31 SDES items")
    body = bytearray()
    for it in items:
        msg = it.message[:255]
        body.append(it.type)
        body.append(len(msg))
        body += msg
    nbytes = 4 + 4 + len(body) + 1  # header + ssrc + items + null
    words = (nbytes + 3) // 4
    out = bytearray()
    out.append((2 << 6) | 1)
    out.append(202)
    out += struct.pack(">H", words - 1)
    out += struct.pack(">I", ssrc & 0xFFFFFFFF)
    out += body
    out += b"\x00" * (words * 4 - len(out))
    return bytes(out)


def gen_bye(ssrcs: list[int]) -> bytes:
    """BYE (gen_bye, rtcp.c:111-127)."""
    if not 0 <= len(ssrcs) <= 31:
        raise ValueError("0..31 ssrcs")
    out = bytearray()
    out.append((2 << 6) | len(ssrcs))
    out.append(203)
    out += struct.pack(">H", len(ssrcs))
    for s in ssrcs:
        out += struct.pack(">I", s & 0xFFFFFFFF)
    return bytes(out)
