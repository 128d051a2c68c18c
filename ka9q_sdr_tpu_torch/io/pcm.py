"""PCM RTP output framing (audio.c).

Float audio -> clipped big-endian int16 -> <=480-word RTP packets with the
reference's silence suppression: all-zero packets are not sent but the RTP
timestamp still advances, and the first packet after silence sets the
marker bit (audio.c:51-61,102-113).  Vectorised with numpy — the int16
conversion of a whole block is one op, not a per-sample loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..net.rtp import RTPHeader, RTPState, PCM_MONO_PT, PCM_STEREO_PT

__all__ = ["PCM_BUFSIZE", "scaleclip_int16", "pcm_to_float", "PCMOutput"]

PCM_BUFSIZE = 480   # 16-bit words per packet, fits Ethernet MTU (audio.c:19)


def scaleclip_int16(x: np.ndarray) -> np.ndarray:
    """scaleclip (audio.c:22-28): clip to +/-1 and scale by 32767."""
    return np.clip(np.asarray(x, np.float64) * 32767.0, -32768, 32767).astype(
        np.int16
    )


def pcm_to_float(data: bytes) -> np.ndarray:
    """Big-endian int16 payload -> float32 in [-1, 1)."""
    return np.frombuffer(data, ">i2").astype(np.float32) / 32767.0


@dataclass
class PCMOutput:
    """Packetise float PCM into RTP (send_mono_output/send_stereo_output,
    audio.c:32-132).  `send` is called with each wire-ready datagram."""

    send: Callable[[bytes], None]
    ssrc: int = 0
    state: RTPState = field(default_factory=RTPState)
    silent: bool = False

    def __post_init__(self):
        self.state.ssrc = self.ssrc

    def send_mono(self, buffer: np.ndarray) -> None:
        self._send(np.asarray(buffer), PCM_MONO_PT, words_per_frame=1)

    def send_mono_i16(self, pcm: np.ndarray) -> None:
        """Pre-quantised int16 samples (device-side scaleclip): only the
        byte swap and packetisation happen here."""
        self._send_pcm(np.asarray(pcm, np.int16), PCM_MONO_PT, 1)

    def advance(self, frames: int) -> None:
        """Suppressed audio: the RTP clock advances without a packet and
        the next audible packet gets the talk-spurt marker
        (audio.c:102-113) — used when silence was decided device-side."""
        self.state.timestamp = (self.state.timestamp + frames) & 0xFFFFFFFF
        self.silent = True

    def send_stereo(self, buffer: np.ndarray) -> None:
        """buffer: (n, 2) float — I left, Q right (linear.c:297-299)."""
        buf = np.asarray(buffer).reshape(-1)
        self._send(buf, PCM_STEREO_PT, words_per_frame=2)

    def _send(self, flat: np.ndarray, pt: int, words_per_frame: int) -> None:
        self._send_pcm(scaleclip_int16(flat), pt, words_per_frame)

    def _send_pcm(self, pcm: np.ndarray, pt: int, words_per_frame: int) -> None:
        for i in range(0, len(pcm), PCM_BUFSIZE):
            chunk = pcm[i : i + PCM_BUFSIZE]
            frames = len(chunk) // words_per_frame
            ts = self.state.timestamp
            self.state.timestamp = (ts + frames) & 0xFFFFFFFF
            if not chunk.any():
                self.silent = True        # suppressed, timestamp advanced
                continue
            hdr = RTPHeader(
                type=pt,
                seq=self.state.seq,
                timestamp=ts,
                ssrc=self.state.ssrc,
                marker=self.silent,       # talk-spurt start (audio.c:109-113)
            )
            self.silent = False
            self.state.seq = (self.state.seq + 1) & 0xFFFF
            self.state.packets += 1
            self.state.bytes += 2 * len(chunk)
            self.send(hdr.to_bytes() + chunk.astype(">i2").tobytes())
