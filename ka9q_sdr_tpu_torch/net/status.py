"""TLV status/command codec with delta compression.

Wire-compatible with the reference (status.h, status.c): self-describing
type-length-value packets; integers big-endian with leading-zero-byte
suppression; floats/doubles bit-cast through integers; a command packet
starts with byte 1, a status response with byte 0 (radio.c:259-266,
funcube.c:775-777).  StatusCompactor reproduces compact_packet
(status.c:150-177): a 256-slot shadow table emits only changed keys, with
a full dump every Nth packet (radio_status.c:207-208 forces every 10th).
"""

from __future__ import annotations

import enum
import struct

import numpy as _np

__all__ = [
    "StatusType",
    "encode_int",
    "encode_float",
    "encode_double",
    "encode_string",
    "encode_eol",
    "decode_int",
    "decode_float",
    "decode_double",
    "decode_packet",
    "StatusCompactor",
]


class StatusType(enum.IntEnum):
    """TLV keys (enum status_type, status.h:6-72)."""

    EOL = 0
    GPS_TIME = 1
    COMMANDS = 2
    INPUT_SOURCE_SOCKET = 3
    INPUT_DEST_SOCKET = 4
    INPUT_SSRC = 5
    INPUT_SAMPRATE = 6
    INPUT_PACKETS = 7
    INPUT_SAMPLES = 8
    INPUT_DROPS = 9
    INPUT_DUPES = 10
    OUTPUT_DEST_SOCKET = 11
    OUTPUT_SSRC = 12
    OUTPUT_TTL = 13
    OUTPUT_SAMPRATE = 14
    OUTPUT_PACKETS = 15
    RADIO_FREQUENCY = 16
    FIRST_LO_FREQUENCY = 17
    SECOND_LO_FREQUENCY = 18
    SHIFT_FREQUENCY = 19
    DOPPLER_FREQUENCY = 20
    DOPPLER_FREQUENCY_RATE = 21
    CALIBRATE = 22
    LNA_GAIN = 23
    MIXER_GAIN = 24
    IF_GAIN = 25
    DC_I_OFFSET = 26
    DC_Q_OFFSET = 27
    IQ_IMBALANCE = 28
    IQ_PHASE = 29
    LOW_EDGE = 30
    HIGH_EDGE = 31
    KAISER_BETA = 32
    FILTER_BLOCKSIZE = 33
    FILTER_FIR_LENGTH = 34
    NOISE_BANDWIDTH = 35
    IF_POWER = 36
    BASEBAND_POWER = 37
    NOISE_DENSITY = 38
    RADIO_MODE = 39
    DEMOD_MODE = 40
    INDEPENDENT_SIDEBAND = 41
    DEMOD_SNR = 42
    DEMOD_GAIN = 43
    FREQ_OFFSET = 44
    PEAK_DEVIATION = 45
    PL_TONE = 46
    PLL_LOCK = 47
    PLL_SQUARE = 48
    PLL_PHASE = 49
    OUTPUT_CHANNELS = 50
    # --- extensions beyond the reference's enum (documented here; the
    # reference protocol ignores unknown keys by design) ---
    SPECTRUM_128 = 100   # 128 x uint8, dB + 120, bins -fs/2..+fs/2
    # Live option editing (the reference edits these in-process via the
    # display 'o'/'k' keys, display.c:958-986; as a network daemon they
    # need command keys).  int 0/1 unless noted.
    PLL_ENABLE = 101     # linear: enable carrier tracking
    FM_FLAT = 102        # FM: bypass de-emphasis
    AGC_HEADROOM = 103   # float, dB (negative)
    AGC_RECOVERY_RATE = 104   # float, dB/s
    AGC_HANGTIME = 105   # float, seconds
    SAVE_STATE = 106     # command: write the ~/.radiostate file now
    #                      (the in-process display 'w' key, over the wire)
    COMMAND_REJECTS = 107  # count of commands dropped as invalid (NaN/
    #                      out-of-span retunes, nonsense filter edges);
    #                      the reference leaves the receiver visibly
    #                      untouched, a network daemon must say WHY


def encode_int(buf: bytearray, type_: int, x: int) -> int:
    """encode_int64 (status.c:32-51): big-endian, leading zero bytes
    suppressed (zero encodes as length 0)."""
    x &= 0xFFFFFFFFFFFFFFFF
    raw = struct.pack(">Q", x).lstrip(b"\x00")
    buf.append(int(type_))
    buf.append(len(raw))
    buf.extend(raw)
    return 2 + len(raw)


def encode_float(buf: bytearray, type_: int, x: float) -> int:
    """encode_float (status.c:85-90): IEEE bits through encode_int."""
    (bits,) = struct.unpack(">I", struct.pack(">f", x))
    return encode_int(buf, type_, bits)


def encode_double(buf: bytearray, type_: int, x: float) -> int:
    """encode_double (status.c:92-96)."""
    (bits,) = struct.unpack(">Q", struct.pack(">d", x))
    return encode_int(buf, type_, bits)


def encode_string(buf: bytearray, type_: int, s: bytes | str) -> int:
    """encode_string (status.c:99-108); truncated at 255."""
    if isinstance(s, str):
        s = s.encode()
    s = s[:255]
    buf.append(int(type_))
    buf.append(len(s))
    buf.extend(s)
    return 2 + len(s)


def encode_eol(buf: bytearray) -> int:
    buf.append(StatusType.EOL)
    return 1


def decode_int(value: bytes) -> int:
    """decode_int (status.c:124-132).  Values longer than 8 bytes keep
    the low 64 bits, as the C's int64 shift-accumulate naturally does —
    an oversized value from a hostile/buggy sender must not raise."""
    x = 0
    for b in value:
        x = (x << 8) | b
    return x & 0xFFFFFFFFFFFFFFFF


def decode_float(value: bytes) -> float:
    """decode_float (status.c:134-140); an 8-byte value is a double,
    narrowed through C float — out-of-range doubles become ±inf exactly
    as the C's (float) cast does."""
    if len(value) == 8:
        with _np.errstate(over="ignore"):     # out-of-range -> inf, silently
            return float(_np.float32(decode_double(value)))
    (f,) = struct.unpack(
        ">f", struct.pack(">I", decode_int(value) & 0xFFFFFFFF)
    )
    return f


def decode_double(value: bytes) -> float:
    if len(value) == 4:
        return float(decode_float(value))
    (d,) = struct.unpack(">d", struct.pack(">Q", decode_int(value)))
    return d


def decode_packet(data: bytes):
    """Iterate (type, value_bytes) pairs of a TLV packet *body* (after the
    leading command/response byte), stopping at EOL.

    Robust against malformed/truncated packets (a network daemon must
    survive any datagram): a type byte with no length, or a length
    running past the end, terminates iteration instead of raising — the
    same effect as the reference's pointer-bounds checks
    (status.c:112-122 decode loop)."""
    i = 0
    n = len(data)
    while i < n:
        t = data[i]
        i += 1
        if t == StatusType.EOL:
            return
        if i >= n:
            return                       # truncated: no length byte
        length = data[i]
        i += 1
        if i + length > n:
            return                       # truncated value
        yield t, bytes(data[i : i + length])
        i += length


class StatusCompactor:
    """Delta compression (compact_packet, status.c:150-177).

    compact(pkt) takes a full TLV packet (leading cmd byte included),
    updates the 256-slot shadow table, and returns a packet containing
    only the keys whose value changed (or everything when force=True)."""

    def __init__(self):
        self._table: dict[int, bytes] = {}

    def compact(self, pkt: bytes, force: bool = False) -> bytes:
        out = bytearray([pkt[0]])
        for t, v in decode_packet(pkt[1:]):
            # the C's shadow table starts zeroed (length 0), so a
            # zero-length value is "unchanged" on first sight
            if force or self._table.get(t, b"") != v:
                self._table[t] = v
                out.append(t)
                out.append(len(v))
                out.extend(v)
        out.append(StatusType.EOL)
        return bytes(out)
