"""PCM -> Opus transcoding sessions (opus.c; port of
``ka9q_sdr_tpu.audio.transcode``, host only).

Joins a PCM stream, demuxes by (sender, SSRC), accumulates samples into
fixed Opus frames (2.5-120 ms, default 20 ms), encodes at 32 kb/s with
optional DTX/FEC, and emits OPUS_PT RTP.  Encoder resets on an RTP marker
or on a gap longer than 4 frame times (opus.c:251-255); the output marker
bit flags talk-spurt starts.  The native engine (``native``
`NativeOpusTranscoder`) runs the same loop in C++, byte for byte.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..net.rtp import (
    RTPHeader,
    RTPState,
    rtp_process,
    PCM_MONO_PT,
    PCM_STEREO_PT,
    OPUS_PT,
    rtp_payload,
)
from .opus_codec import OpusEncoder, OpusError

__all__ = ["OpusSession", "OpusTranscoder", "LEGAL_FRAMES_MS"]

SAMPRATE = 48000
#: Legal Opus frame durations, ms (opus.c option check)
LEGAL_FRAMES_MS = (2.5, 5, 10, 20, 40, 60, 80, 100, 120)


class OpusSession:
    """Per-(sender, SSRC) encoder state (struct session, opus.c:25-44)."""

    def __init__(
        self,
        ssrc: int,
        send: Callable[[bytes], None],
        bitrate: int = 32000,
        frame_ms: float = 20.0,
        dtx: bool = False,
        fec: int = 0,       # expected loss %, 0 = FEC off (opus.c:62)
    ):
        if frame_ms not in LEGAL_FRAMES_MS:
            raise ValueError(f"illegal Opus frame {frame_ms} ms")
        self.ssrc = ssrc
        self.send = send
        self.frame_len = int(SAMPRATE * frame_ms / 1000)
        self.encoder = OpusEncoder(SAMPRATE, 2, bitrate, dtx=dtx, fec=fec)
        self.buf = np.zeros((0, 2), np.float32)
        self.rtp_in = RTPState()
        self.seq = 0
        self.timestamp = 0
        self.silent = True

    def feed(self, hdr: RTPHeader, payload: bytes) -> None:
        channels = 1 if hdr.type == PCM_MONO_PT else 2
        # ragged tails are truncated, not crashed on (the reference's
        # integer frame-count division ignores trailing partial bytes)
        payload = payload[: len(payload) // (2 * channels) * (2 * channels)]
        frames = len(payload) // (2 * channels)
        gap = rtp_process(self.rtp_in, hdr, frames)
        if gap < 0:
            return
        if hdr.marker or gap > 4 * self.frame_len:
            # reset on talk-spurt start or long gap (opus.c:251-255), in
            # place (OPUS_RESET_STATE) like the reference: recreating the
            # encoder would leak its native allocation every squelch open
            self.encoder.reset()
            self.buf = np.zeros((0, 2), np.float32)
            self.timestamp = (self.timestamp + gap) & 0xFFFFFFFF
            self.silent = True
        elif gap > 0:
            self.feed_pcm(np.zeros((gap, 2), np.float32))
        pcm = np.frombuffer(payload, ">i2").astype(np.float32) / 32767.0
        if channels == 1:
            pcm = np.repeat(pcm[:, None], 2, axis=1)
        else:
            pcm = pcm.reshape(-1, 2)
        self.feed_pcm(pcm)

    def feed_pcm(self, pcm: np.ndarray) -> None:
        self.buf = np.concatenate([self.buf, pcm], axis=0)
        while len(self.buf) >= self.frame_len:
            frame, self.buf = self.buf[: self.frame_len], self.buf[self.frame_len:]
            packet = self.encoder.encode(frame)
            ts = self.timestamp
            self.timestamp = (ts + self.frame_len) & 0xFFFFFFFF
            if len(packet) <= 2:
                # DTX: don't transmit, timestamp advances (opus.c:372-379)
                self.silent = True
                continue
            hdr = RTPHeader(
                type=OPUS_PT,
                seq=self.seq,
                timestamp=ts,
                ssrc=self.ssrc,
                marker=self.silent,
            )
            self.silent = False
            self.seq = (self.seq + 1) & 0xFFFF
            self.send(hdr.to_bytes() + packet)


class OpusTranscoder:
    """Session demultiplexer (opus.c main loop).

    max_sessions caps the session table -- the reference grows its list
    without bound (opus.c:300-320), but each session here holds a native
    libopus encoder, so a hostile sender spraying random SSRCs would
    otherwise exhaust memory (the native engine has the same cap).
    Packets for SSRCs beyond the cap are counted in `rejected` and
    dropped."""

    def __init__(self, send: Callable[[bytes], None],
                 max_sessions: int = 1024, **opts):
        self.send = send
        self.opts = opts
        self.max_sessions = max_sessions
        self.rejected = 0
        self.sessions: dict[tuple, OpusSession] = {}

    def feed_packet(self, data: bytes, sender: tuple = ("", 0)) -> None:
        try:
            hdr, off = RTPHeader.from_bytes(data)
        except ValueError:
            return
        if hdr.type not in (PCM_MONO_PT, PCM_STEREO_PT):
            return
        # full sender address in the key (opus.c:287 memcmps the whole
        # sockaddr): two senders on one host sharing an SSRC must not
        # merge into one interleaved session
        key = (sender[0], sender[1] if len(sender) > 1 else 0, hdr.ssrc)
        sess = self.sessions.get(key)
        if sess is None:
            if len(self.sessions) >= self.max_sessions:
                self.rejected += 1
                return
            sess = OpusSession(hdr.ssrc, self.send, **self.opts)
            self.sessions[key] = sess
        try:
            sess.feed(hdr, rtp_payload(hdr, data, off))
        except OpusError:
            return    # one corrupt packet must not kill the daemon
