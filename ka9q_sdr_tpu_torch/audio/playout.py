"""Multi-stream playout mixer (monitor.c; port of
``ka9q_sdr_tpu.audio.playout``, host numpy).

A shared float stereo ring buffer takes every session's audio *additively*
(monitor.c:479-522); the output drain reads consecutive frames and zeroes
behind itself (the portaudio callback, monitor.c:360-386 -- here a pull
method so output can go to a sound card, a file, or a socket).

Jitter management follows monitor.c:452-474: each session maps RTP
timestamps to ring positions with an initial 100 ms playout delay; a late
packet bumps the session's delay by 1 ms and is dropped; an RTP marker
(talk-spurt start) re-anchors the mapping.  Pan applies per-channel gain
plus up to 1 ms of interaural delay (monitor.c:435-449).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..net.rtp import (RTPHeader, rtp_payload, PCM_MONO_PT, PCM_STEREO_PT,
                       OPUS_PT)
from .opus_codec import OPUS_AVAILABLE, OpusDecoder, OpusError

__all__ = ["PlayoutSession", "Mixer", "SAMPRATE", "RING_FRAMES"]

SAMPRATE = 48000                  # monitor.c:81-86 (fixed)
RING_FRAMES = 1 << 19             # ~10.9 s stereo ring (monitor.c)
START_DELAY = SAMPRATE // 10      # initial playout delay 100 ms
LATE_BUMP = SAMPRATE // 1000      # +1 ms per late packet
MAX_PAN_DELAY = SAMPRATE // 1000  # <=1 ms interaural delay


class PlayoutSession:
    """Per-SSRC decode + playout state (struct session, monitor.c)."""

    def __init__(self, ssrc: int, pt: int):
        self.ssrc = ssrc
        self.type = pt
        self.playout = START_DELAY
        self.anchor_ts: Optional[int] = None   # RTP ts at anchor
        self.anchor_pos = 0                    # ring position of anchor
        self.gain = 1.0
        self.pan = 0.0      # -1 (left) .. +1 (right)
        self.muted = False
        self.packets = 0
        self.lates = 0
        self.decoder = None

    def ensure_decoder(self) -> bool:
        """Lazy per-packet-type decoder creation (monitor.c:497-504
        'if(!sp->opus) opus_decoder_create'): a session first seen as PCM
        can switch to Opus on the same SSRC."""
        if self.decoder is None and OPUS_AVAILABLE:
            self.decoder = OpusDecoder(SAMPRATE, 2)
        return self.decoder is not None

    def pan_gains_delays(self) -> tuple[float, float, int, int]:
        """Linear pan law plus interaural delay (monitor.c:435-449):
        -6 dB per channel at center; the disfavored channel is delayed
        up to 1 ms."""
        lg = self.gain * (1.0 - self.pan) / 2.0
        rg = self.gain * (1.0 + self.pan) / 2.0
        ld = round(max(0.0, self.pan) * MAX_PAN_DELAY)
        rd = round(max(0.0, -self.pan) * MAX_PAN_DELAY)
        return lg, rg, ld, rd


class Mixer:
    """The shared ring + session demux (monitor.c main structures).

    max_sessions caps the table: the reference grows its session list
    without bound, but an Opus session here lazily allocates a native
    decoder, so a flood of random-SSRC datagrams would otherwise exhaust
    the monitor's memory.  Beyond the cap, packets for unseen SSRCs are
    counted in `rejected` and dropped (existing sessions keep playing)."""

    def __init__(self, max_sessions: int = 256):
        self.ring = np.zeros((RING_FRAMES, 2), np.float32)
        self.rptr = 0          # next frame the output will read
        self.frames_out = 0
        self.max_sessions = max_sessions
        self.rejected = 0
        self.sessions: dict[int, PlayoutSession] = {}

    def feed_packet(self, data: bytes) -> None:
        try:
            hdr, off = RTPHeader.from_bytes(data)
        except ValueError:
            return
        if hdr.type not in (PCM_MONO_PT, PCM_STEREO_PT, OPUS_PT):
            return
        sess = self.sessions.get(hdr.ssrc)
        if sess is None:
            if len(self.sessions) >= self.max_sessions:
                self.rejected += 1
                return
            sess = PlayoutSession(hdr.ssrc, hdr.type)
            self.sessions[hdr.ssrc] = sess
        sess.packets += 1
        sess.type = hdr.type      # updated every packet (monitor.c:430)
        payload = rtp_payload(hdr, data, off)
        if not payload:
            return

        if hdr.type == OPUS_PT:
            if not sess.ensure_decoder():
                return
            if hdr.marker:
                # clean decoder state for the new talk spurt
                # (monitor.c:481-483 OPUS_RESET_STATE)
                sess.decoder.reset()
            try:
                audio = sess.decoder.decode(payload)
            except OpusError:
                return        # one corrupt packet must not kill the daemon
        else:
            # truncate a ragged tail instead of crashing: the reference's
            # integer frame-count division ignores trailing partial bytes
            frame = 2 if hdr.type == PCM_MONO_PT else 4
            payload = payload[: len(payload) // frame * frame]
            pcm = np.frombuffer(payload, ">i2").astype(np.float32) / 32767.0
            audio = (
                np.repeat(pcm[:, None], 2, axis=1)
                if hdr.type == PCM_MONO_PT
                else pcm.reshape(-1, 2)
            )
        if len(audio) == 0:
            return

        # Playout positioning (monitor.c:452-474)
        if hdr.marker or sess.anchor_ts is None:
            if hdr.marker:
                # a talk-spurt start resets the playout delay too
                # (monitor.c:459), so late bumps don't accumulate across
                # spurts forever; the late-path re-anchor (anchor_ts=None)
                # must keep its bumped delay
                sess.playout = START_DELAY
            sess.anchor_ts = hdr.timestamp
            sess.anchor_pos = (self.rptr + sess.playout) % RING_FRAMES
            rel = 0
        else:
            rel = (hdr.timestamp - sess.anchor_ts) & 0xFFFFFFFF
            if rel >= 1 << 31:       # negative (old) -- drop
                return
        wpos = (sess.anchor_pos + rel) % RING_FRAMES
        # Late check: is wpos behind the read pointer?
        behind = (self.rptr - wpos) % RING_FRAMES
        if 0 < behind < RING_FRAMES // 2:
            sess.playout += LATE_BUMP    # bump delay 1 ms, drop (mon.c:469-473)
            sess.lates += 1
            sess.anchor_ts = None        # re-anchor on next packet
            return

        if sess.muted:
            # a muted session still advances its anchor/late bookkeeping
            # (the reference mixes it at zero gain, monitor.c:439-449);
            # skipping the ring add is just cheaper
            return
        lg, rg, ld, rd = sess.pan_gains_delays()
        self._ring_add(0, (wpos + ld) % RING_FRAMES, audio[:, 0] * lg)
        self._ring_add(1, (wpos + rd) % RING_FRAMES, audio[:, 1] * rg)

    def _ring_add(self, chan: int, start: int, samples: np.ndarray) -> None:
        """Additive ring write as at most two contiguous slice adds
        (the reference's two-chunk wrap handling, monitor.c:360-386):
        per-packet write indices are unique, so np.add.at's duplicate-safe
        inner loop would be wasted work."""
        n = len(samples)
        first = min(n, RING_FRAMES - start)
        self.ring[start : start + first, chan] += samples[:first]
        if first < n:
            self.ring[: n - first, chan] += samples[first:]

    def read(self, frames: int) -> np.ndarray:
        """Drain `frames` stereo frames; zero the ring behind the read
        pointer (pa_callback, monitor.c:360-386)."""
        out = np.empty((frames, 2), np.float32)
        idx = (self.rptr + np.arange(frames)) % RING_FRAMES
        out[:] = self.ring[idx]
        self.ring[idx] = 0.0
        self.rptr = (self.rptr + frames) % RING_FRAMES
        self.frames_out += frames
        return out
