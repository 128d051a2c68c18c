"""RTP I/Q stream -> dense fixed-size blocks for the device.

The reference's proc_samples loop (radio.c:41-149) pulls packets off a
seq-sorted queue, zero-fills timestamp gaps (keeping the LO phase and
sample count correct, radio.c:81-99), scales int16/int8 to float, and
fires the master filter every L samples.  Here the host does exactly the
irregular part — reordering, gap fill, scaling — and the device sees only
dense L-sample blocks (SURVEY.md §7 "variable-length/irregular I/O").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from ..net.rtp import RTPHeader, RTPState, rtp_process, IQ_PT, IQ_PT8

__all__ = ["BlockAssembler"]

#: Gap limit: don't zero-fill more than this many samples (radio.c:77).
MAX_TIME_STEP = 192000

SCALE16 = 1.0 / 32767.0
SCALE8 = 1.0 / 127.0


@dataclass
class BlockAssembler:
    """Feed RTP I/Q packets in; iterate dense complex64 blocks out.

    Skips the legacy 24-byte status header unconditionally, exactly like
    the reference (main.c:338-341); drops dupes, zero-fills gaps.
    """

    block_len: int
    skip_legacy_status: bool = True
    rtp_state: RTPState = field(default_factory=RTPState)
    samples: int = 0        # total samples accepted (radio.c input.samples)
    malformed: int = 0      # datagrams dropped as unparseable RTP

    def __post_init__(self):
        self._buf = np.zeros(self.block_len, np.complex64)
        self._fill = 0
        self._ready: list[np.ndarray] = []

    def _append(self, x: np.ndarray) -> None:
        n = len(x)
        pos = 0
        while pos < n:
            take = min(n - pos, self.block_len - self._fill)
            self._buf[self._fill : self._fill + take] = x[pos : pos + take]
            self._fill += take
            pos += take
            if self._fill == self.block_len:
                self._ready.append(self._buf.copy())
                self._fill = 0

    def push(self, packet: bytes) -> None:
        """One UDP datagram: RTP header + (legacy status?) + I/Q payload.

        Malformed datagrams are counted and dropped, never raised — a
        live daemon's ingest loop feeds recv() output here directly and
        must survive anything on the wire (the reference's ntoh_rtp
        returns a failure its caller drops, multicast.c:242-277)."""
        try:
            hdr, off = RTPHeader.from_bytes(packet)
        except ValueError:
            self.malformed += 1
            return
        payload = packet[off:]
        if hdr.type not in (IQ_PT, IQ_PT8):
            return
        if self.skip_legacy_status:
            # the 24-byte legacy status header precedes the samples in
            # every I/Q packet; 'radio' skips it unconditionally
            # (main.c:338-341)
            payload = payload[24:]
        if hdr.type == IQ_PT:
            sampcount = len(payload) // 4
            raw = np.frombuffer(payload[: sampcount * 4], "<i2").astype(np.float32) * SCALE16
        else:
            sampcount = len(payload) // 2
            raw = np.frombuffer(payload[: sampcount * 2], np.int8).astype(np.float32) * SCALE8
        time_step = rtp_process(self.rtp_state, hdr, sampcount)
        if time_step < 0 or time_step > MAX_TIME_STEP:
            return  # dupe/old/too-big jump (radio.c:77-79)
        if time_step > 0:
            self.samples += time_step
            self._append(np.zeros(time_step, np.complex64))
        self.samples += sampcount
        self._append((raw[0::2] + 1j * raw[1::2]).astype(np.complex64))

    def blocks(self) -> Iterator[np.ndarray]:
        """Drain completed blocks."""
        out, self._ready = self._ready, []
        yield from out
