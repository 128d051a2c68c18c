"""AX.25 frame utilities (ax25.c).

Callsign shifted-ASCII decode, CRC-CCITT check (and generation, for test
fixtures), header parse into source/dest/digipeater path/control/type/
info, APRS base-91, and TNC2 monitor-format conversion (aprsfeed.c:199-239).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "AX25Frame",
    "get_callsign",
    "encode_callsign",
    "crc_good",
    "append_crc",
    "ax25_parse",
    "decode_base91",
    "frame_to_tnc2",
]

MAX_DIGI = 10       # ax25.h:12 (differentially verified vs the C)
CRC_POLY = 0x8408


def get_callsign(field6: bytes) -> str:
    """Shifted-ASCII callsign + SSID -> "KA9Q-11" (ax25.c:15-31)."""
    call = ""
    for i in range(6):
        c = chr((field6[i] >> 1) & 0x7F)
        if c == " ":
            break
        call += c
    # the C's snprintf("%s-%d", ...) stops at an embedded NUL
    # (ax25.c:26-29); differentially verified against the compiled C
    call = call.split("\0", 1)[0]
    ssid = (field6[6] >> 1) & 0xF
    return f"{call}-{ssid}" if ssid else call


def encode_callsign(call: str, last: bool = False, h: bool = False) -> bytes:
    """Inverse of get_callsign, for building test frames."""
    if "-" in call:
        base, ssid_s = call.split("-", 1)
        ssid = int(ssid_s)
    else:
        base, ssid = call, 0
    base = base.upper().ljust(6)[:6]
    out = bytes((ord(c) << 1) for c in base)
    last_bit = 1 if last else 0
    # reserved bits 5-6 are always set on air; 0x80 additionally marks
    # has-been-repeated (the h bit)
    return out + bytes(
        [((ssid & 0xF) << 1) | last_bit | 0x60 | (0x80 if h else 0)])


def crc_good(frame: bytes) -> bool:
    """AX.25 CRC-CCITT check over frame *including* the 2 CRC bytes
    (crc_good, ax25.c:140-156)."""
    crc = 0xFFFF
    for byte in frame:
        for _ in range(8):
            feedback = CRC_POLY if (crc ^ byte) & 1 else 0
            crc = (crc >> 1) ^ feedback
            byte >>= 1
    return crc == 0xF0B8


def append_crc(frame: bytes) -> bytes:
    """Append the 2-byte AX.25 FCS so crc_good(out) is true."""
    crc = 0xFFFF
    for byte in frame:
        for _ in range(8):
            feedback = CRC_POLY if (crc ^ byte) & 1 else 0
            crc = (crc >> 1) ^ feedback
            byte >>= 1
    crc ^= 0xFFFF
    return frame + bytes([crc & 0xFF, (crc >> 8) & 0xFF])


def decode_base91(data: bytes | str) -> int:
    """APRS base-91 (ax25.c:159-165)."""
    if isinstance(data, str):
        data = data.encode()
    result = 0
    for i in range(4):
        result = 91 * result + data[i] - 33
    return result


@dataclass
class AX25Frame:
    """struct ax25_frame (ax25.h)."""

    source: str = ""
    dest: str = ""
    digipeaters: list = field(default_factory=list)  # (name, h) pairs
    control: int = 0
    type: int = 0
    information: bytes = b""
    dest_raw: bytes = b""   # raw shifted dest field (needed by MIC-E)


def ax25_parse(data: bytes) -> AX25Frame | None:
    """Parse an AX.25 UI frame (ax25_parse, ax25.c:168-210).

    `data` includes the trailing CRC (info_len excludes it, matching the
    reference).  Returns None on malformed frames."""
    if len(data) < 16:
        return None
    ctl_offs = next((i for i, b in enumerate(data) if b & 1), None)
    if ctl_offs is None:
        return None
    ctl_offs += 1
    if ctl_offs % 7:
        return None
    # ndigi may be -1 (address end flag inside the dest field): the C
    # accepts such frames with an empty digipeater list and source read
    # from the control area (ax25.c:185-199; differentially verified) —
    # only MORE than MAX_DIGI digis is rejected
    ndigi = ctl_offs // 7 - 2
    if ndigi > MAX_DIGI:
        return None
    # compute the info length FIRST: when negative the C rejects before
    # its control/type reads matter, and checking here keeps the indexing
    # below in bounds (ctl_offs + 2 + info_len == len - 2)
    info_len = len(data) - (ctl_offs + 2) - 2
    if info_len < 0:
        return None
    out = AX25Frame(
        source=get_callsign(data[7:14]),
        dest=get_callsign(data[0:7]),
        dest_raw=bytes(data[0:7]),
    )
    for i in range(max(0, ndigi)):
        off = 7 * (2 + i)
        out.digipeaters.append(
            (get_callsign(data[off : off + 7]), bool(data[off + 6] & 0x80))
        )
    out.control = data[ctl_offs]
    out.type = data[ctl_offs + 1]
    out.information = bytes(data[ctl_offs + 2 : ctl_offs + 2 + info_len])
    return out


def frame_to_tnc2(frame: AX25Frame, qcall: str | None = None) -> str:
    """AX.25 -> TNC2 monitor string "SRC>DST,DIGI*,DIGI[,qAO,CALL]:info"
    as sent to APRS-IS (aprsfeed.c:199-239).

    `qcall` appends the reference's receive-only q-construct ",qAO,CALL"
    (aprsfeed.c:222-224) identifying the i-gate.  The info field gets the
    reference's exact character filter: parity stripped (c & 0x7f) and
    CR/LF/NUL dropped ANYWHERE (aprsfeed.c:228-236) — APRS-IS is a
    line-oriented protocol, so an embedded newline would let an RF frame
    inject a second, forged packet into the upload."""
    path = frame.source + ">" + frame.dest
    for name, h in frame.digipeaters:
        path += "," + name + ("*" if h else "")
    if qcall:
        path += ",qAO," + qcall
    info = "".join(
        c for c in (chr(b & 0x7F) for b in frame.information)
        if c not in ("\r", "\n", "\0")
    )
    return path + ":" + info
