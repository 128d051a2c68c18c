"""Minimal libopus binding via ctypes (port of
``ka9q_sdr_tpu.audio.opus_codec``; no third-party wheel needed).

Exposes exactly what the reference modules use: encoder create/encode_float
with bitrate / DTX / FEC controls (opus.c:215-244) and decoder
create/decode_float with PLC and FEC (monitor.c:479-517).  Gated on
libopus being present; OPUS_AVAILABLE tells callers to skip.  Loading the
shared library is the only work done at import.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

__all__ = ["OPUS_AVAILABLE", "OpusEncoder", "OpusDecoder", "OpusError"]

_lib = None
_name = ctypes.util.find_library("opus")
if _name:
    try:
        _lib = ctypes.CDLL(_name)
    except OSError:
        _lib = None

OPUS_AVAILABLE = _lib is not None

# opus_defines.h constants
OPUS_APPLICATION_AUDIO = 2049
OPUS_SET_BITRATE = 4002
OPUS_SET_DTX = 4016
OPUS_SET_INBAND_FEC = 4012
OPUS_SET_PACKET_LOSS_PERC = 4014
OPUS_RESET_STATE = 4028

if OPUS_AVAILABLE:
    _lib.opus_encoder_destroy.restype = None
    _lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    _lib.opus_decoder_destroy.restype = None
    _lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    _lib.opus_encoder_create.restype = ctypes.c_void_p
    _lib.opus_encoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib.opus_encode_float.restype = ctypes.c_int
    _lib.opus_encode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    _lib.opus_encoder_ctl.restype = ctypes.c_int
    _lib.opus_decoder_create.restype = ctypes.c_void_p
    _lib.opus_decoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    _lib.opus_decode_float.restype = ctypes.c_int
    _lib.opus_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]


class OpusError(RuntimeError):
    pass


class OpusEncoder:
    """48 kHz stereo float encoder (opus.c:215-244)."""

    def __init__(
        self,
        samprate: int = 48000,
        channels: int = 2,
        bitrate: int = 32000,
        dtx: bool = False,
        fec: int = 0,
    ):
        # fec is the expected packet-loss percentage (opus.c:62,232-239):
        # nonzero enables inband FEC and sets OPUS_SET_PACKET_LOSS_PERC.
        if not OPUS_AVAILABLE:
            raise OpusError("libopus not available")
        err = ctypes.c_int()
        self._enc = _lib.opus_encoder_create(
            samprate, channels, OPUS_APPLICATION_AUDIO, ctypes.byref(err)
        )
        if err.value != 0:
            raise OpusError(f"opus_encoder_create: {err.value}")
        self.channels = channels
        _lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), OPUS_SET_BITRATE,
                              ctypes.c_int(bitrate))
        _lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), OPUS_SET_DTX,
                              ctypes.c_int(int(dtx)))
        if fec:
            _lib.opus_encoder_ctl(ctypes.c_void_p(self._enc),
                                  OPUS_SET_INBAND_FEC, ctypes.c_int(1))
            _lib.opus_encoder_ctl(ctypes.c_void_p(self._enc),
                                  OPUS_SET_PACKET_LOSS_PERC,
                                  ctypes.c_int(int(fec)))

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: (frames, channels) float32.  Returns the Opus packet (may be
        1-2 bytes during DTX silence)."""
        pcm = np.ascontiguousarray(pcm, np.float32)
        frames = pcm.shape[0]
        out = ctypes.create_string_buffer(4000)
        n = _lib.opus_encode_float(
            ctypes.c_void_p(self._enc),
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames, out, len(out),
        )
        if n < 0:
            raise OpusError(f"opus_encode_float: {n}")
        return out.raw[:n]

    def reset(self) -> None:
        """In-place state reset, like the reference's talk-spurt handling
        (opus.c:253 OPUS_RESET_STATE) -- re-creating an encoder instead
        would leak its native allocation every squelch re-open."""
        _lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), OPUS_RESET_STATE)

    def __del__(self):
        enc, self._enc = getattr(self, "_enc", None), None
        try:
            if enc and _lib is not None:
                _lib.opus_encoder_destroy(ctypes.c_void_p(enc))
        except TypeError:
            pass  # interpreter teardown already nulled ctypes globals


class OpusDecoder:
    """48 kHz stereo float decoder (monitor.c:505-517)."""

    def __init__(self, samprate: int = 48000, channels: int = 2):
        if not OPUS_AVAILABLE:
            raise OpusError("libopus not available")
        err = ctypes.c_int()
        self._dec = _lib.opus_decoder_create(samprate, channels,
                                             ctypes.byref(err))
        if err.value != 0:
            raise OpusError(f"opus_decoder_create: {err.value}")
        self.channels = channels

    def decode(self, packet: bytes | None, max_frames: int = 5760) -> np.ndarray:
        """Decode one packet -> (frames, channels) float32; packet=None
        invokes packet-loss concealment."""
        out = np.empty((max_frames, self.channels), np.float32)
        n = _lib.opus_decode_float(
            ctypes.c_void_p(self._dec),
            packet, len(packet) if packet else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_frames, 0,
        )
        if n < 0:
            raise OpusError(f"opus_decode_float: {n}")
        return out[:n]

    def reset(self) -> None:
        """Decoder state reset on talk-spurt start (monitor.c:481-483)."""
        _lib.opus_decoder_ctl(ctypes.c_void_p(self._dec), OPUS_RESET_STATE)

    def __del__(self):
        dec, self._dec = getattr(self, "_dec", None), None
        try:
            if dec and _lib is not None:
                _lib.opus_decoder_destroy(ctypes.c_void_p(dec))
        except TypeError:
            pass  # interpreter teardown already nulled ctypes globals
