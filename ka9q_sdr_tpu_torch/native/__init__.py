"""Native C++ runtime: the high-rate RTP I/Q engine (``rtp_engine.cc``).

A copy of the JAX package's engine limited to what the serving daemons
use: the I/Q receive ring (`RTPReceiver`), the paced I/Q sender
(`RTPSender`), the bank's PCM fan-out (`PCMFanoutSender`) and the wire
parser probe (`parse_probe`).  It is compiled with g++ at first use (plain C
ABI, loaded with ctypes) into ``build/`` at the root of the checkout, named
by the hash of its source, so an edited source rebuilds.  Where no compiler
is present, ``NATIVE_AVAILABLE`` is False and the daemons take the Python
transport.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "NATIVE_AVAILABLE", "RTPReceiver", "RTPSender", "PCMFanoutSender",
    "parse_probe", "build",
]

_SRC = Path(__file__).resolve().parent / "rtp_engine.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_lib = None
_lock = threading.Lock()


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librtp_engine-{digest}.so"


def build(force: bool = False) -> bool:
    """Compile the engine if no build of the current source exists.
    Returns success.

    Compiles to a temporary file and renames it onto the library: several
    processes may build at once, and none may load a half-written library
    (rename(2) is atomic; a loser of the race replaces the winner's
    identical output).  No ``-march=native``: the build directory may be
    copied to another machine with the checkout."""
    so = _so_path()
    if not force and so.exists():
        return True
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
           str(_SRC), "-lpthread"]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not build():
            raise OSError("cannot build librtp_engine.so")
        lib = ctypes.CDLL(str(_so_path()))
        lib.rtp_parse_probe.restype = ctypes.c_int
        lib.rtp_parse_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.rtp_rx_create.restype = ctypes.c_void_p
        lib.rtp_rx_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.rtp_rx_get_block.restype = ctypes.c_int
        lib.rtp_rx_get_block.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.rtp_rx_get_block_i16.restype = ctypes.c_int
        lib.rtp_rx_get_block_i16.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ]
        lib.rtp_rx_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.rtp_rx_destroy.argtypes = [ctypes.c_void_p]
        lib.rtp_tx_create.restype = ctypes.c_void_p
        lib.rtp_tx_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_uint,
        ]
        lib.rtp_tx_send.restype = ctypes.c_int
        lib.rtp_tx_send.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.rtp_tx_destroy.argtypes = [ctypes.c_void_p]
        lib.pcm_tx_create.restype = ctypes.c_void_p
        lib.pcm_tx_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.pcm_tx_send_block.restype = ctypes.c_longlong
        lib.pcm_tx_send_block.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.pcm_tx_destroy.argtypes = [ctypes.c_void_p]
        lib.pcm_tx_set_ssrc.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
        ]
        _lib = lib
        return lib


def __getattr__(name):
    # NATIVE_AVAILABLE builds the engine at its first read, not at import
    if name == "NATIVE_AVAILABLE":
        try:
            _load()
            return True
        except OSError:
            return False
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _resolve_candidates(group: str) -> list[str]:
    """Resolve a hostname or literal to the numeric forms the C engine's
    AI_NUMERICHOST getaddrinfo accepts -- dual-stack, all results in
    getaddrinfo order so callers can try each family like the reference's
    PF_UNSPEC loop (multicast.c:173-201).  IPv6 zone suffixes (%eth0) pass
    through; the zone getaddrinfo returns separately (sa[3]) is reattached
    numerically."""
    import socket as _socket

    try:
        infos = _socket.getaddrinfo(
            group, None, _socket.AF_UNSPEC, _socket.SOCK_DGRAM)
    except OSError as e:
        raise OSError(f"cannot resolve multicast group {group!r}: {e}")
    out: list[str] = []
    for family, _, _, _, sa in infos:
        host = sa[0]
        if family == _socket.AF_INET6 and sa[3] and "%" not in host:
            host = f"{host}%{sa[3]}"
        if host not in out:
            out.append(host)
    return out


def parse_probe(data: bytes):
    """Test-only: run the native wire parser on a datagram.  Returns
    (version, type, seq, timestamp, ssrc, marker, payload_offset,
    pad_len) or None if the engine would drop it as malformed."""
    lib = _load()
    out = (ctypes.c_longlong * 8)()
    if not lib.rtp_parse_probe(data, len(data), out):
        return None
    return tuple(int(v) for v in out)


class RTPReceiver:
    """Native multicast (or unicast) I/Q receive engine -> dense blocks.

    get_block() returns an (L, 2) float32 array and get_block_i16() an
    (L, 2) int16 array, or None on timeout."""

    def __init__(
        self,
        group: str,
        port: int = 5004,
        block_len: int = 3840,
        skip_legacy: bool = True,
        ring_blocks: int = 64,
    ):
        self._lib = _load()
        self.block_len = block_len
        # resolve hostnames host-side (dual-stack); the C engine takes
        # numeric literals only and fails loudly instead of falling back
        # to a deaf INADDR_ANY bind
        self._h = None
        for cand in _resolve_candidates(group):
            self._h = self._lib.rtp_rx_create(
                cand.encode(), port, block_len, int(skip_legacy),
                ring_blocks
            )
            if self._h:
                break
        if not self._h:
            raise OSError(f"rtp_rx_create failed for {group}:{port} "
                          "(bad group address, bind, or membership)")

    def get_block(self, timeout_ms: int = 1000):
        out = np.empty((self.block_len, 2), np.float32)
        r = self._lib.rtp_rx_get_block(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            timeout_ms,
        )
        return out if r else None

    def get_block_i16(self, timeout_ms: int = 1000):
        """Raw (L, 2) int16 block -- the preferred ingest path: half the
        host-to-device bytes, scaled on the card."""
        out = np.empty((self.block_len, 2), np.int16)
        r = self._lib.rtp_rx_get_block_i16(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            timeout_ms,
        )
        return out if r else None

    def stats(self) -> dict:
        buf = (ctypes.c_longlong * 6)()
        self._lib.rtp_rx_stats(self._h, buf)
        return dict(
            zip(
                ("packets", "drops", "dupes", "gap_samples", "overruns",
                 "blocks"),
                list(buf),
            )
        )

    def close(self):
        if self._h:
            self._lib.rtp_rx_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PCMFanoutSender:
    """Native multichannel PCM RTP fan-out (audio.c semantics per channel,
    batched for the bank): one call per bank block sends every active
    channel's big-endian PCM with silence suppression, talk-spurt markers
    and per-channel SSRC/seq/timestamp state."""

    def __init__(
        self,
        group: str,
        port: int = 5004,
        ttl: int = 1,
        ssrc_base: int = 1,
        max_channels: int = 4096,
        channels: int = 1,
    ):
        self._lib = _load()
        self._h = None
        for cand in _resolve_candidates(group):
            self._h = self._lib.pcm_tx_create(
                cand.encode(), port, ttl, ssrc_base, max_channels, channels
            )
            if self._h:
                break
        if not self._h:
            raise OSError(f"pcm_tx_create failed for {group}:{port}")
        self.channels = channels

    def send_block(
        self,
        pcm_i16: np.ndarray,
        ch_ids: np.ndarray | None = None,
        pkt_samples: int = 480,
    ) -> int:
        """pcm_i16: (n_rows, block_len[, channels]) host-order int16, or
        the rows flattened to (n_rows, block_len * channels).  ch_ids:
        (n_rows,) int32 logical channel per row, -1 = unused slot
        (bank_step_active's idx); None means row i IS channel i.  Returns
        packets sent."""
        arr = np.ascontiguousarray(pcm_i16, np.int16)
        n_rows = arr.shape[0]
        # frames per row: a flattened stereo row holds 2 words per frame
        # (the JAX package's wrapper passes its width and reads past it)
        block_len = (arr.size // (n_rows * self.channels) if n_rows
                     else arr.shape[1])
        if ch_ids is None:
            ch_ids = np.arange(n_rows, dtype=np.int32)
        ids = np.ascontiguousarray(ch_ids, np.int32)
        return int(self._lib.pcm_tx_send_block(
            self._h,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_rows, block_len, pkt_samples,
        ))

    def set_ssrc(self, ch: int, ssrc: int) -> None:
        """Override slot ch's wire SSRC (live mode migration: the slot
        adopts the migrating channel's SSRC; its output stream restarts
        like the reference's respawned demod thread, radio.c:322-374).
        ssrc=0 restores the default base+slot mapping."""
        self._lib.pcm_tx_set_ssrc(self._h, ch, ssrc)

    def close(self):
        if self._h:
            self._lib.pcm_tx_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RTPSender:
    """Native paced I/Q sender (iqplay's loop at wire rate)."""

    def __init__(
        self,
        group: str,
        port: int = 5004,
        samprate: int = 192000,
        frequency: float = 0.0,
        ttl: int = 1,
        ssrc: int = 0,
    ):
        self._lib = _load()
        self._h = None
        for cand in _resolve_candidates(group):
            self._h = self._lib.rtp_tx_create(
                cand.encode(), port, samprate, frequency, ttl, ssrc or 1
            )
            if self._h:
                break
        if not self._h:
            raise OSError(f"rtp_tx_create failed for {group}:{port}")

    def send(self, iq_int16: np.ndarray, pkt_samples: int = 240,
             realtime: bool = True) -> int:
        """iq_int16: interleaved (2n,) int16.  Returns packets sent."""
        arr = np.ascontiguousarray(iq_int16, np.int16)
        return self._lib.rtp_tx_send(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(arr) // 2, pkt_samples, int(realtime),
        )

    def close(self):
        if self._h:
            self._lib.rtp_tx_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
