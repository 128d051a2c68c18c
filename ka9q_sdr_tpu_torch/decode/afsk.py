"""AFSK-1200 (Bell 202) demodulator + HDLC deframer (packet.c:266-414).

Structure mirrors the reference decode_task:

- an overlap-save REAL master filter (L=1000, M=1049, N=2048) whose slave
  produces an analytic, band-limited +100..+4000 Hz signal
  (packet.c:272-273);
- mark/space replica NCOs at -1200/-2200 Hz with boxcar
  integrate-and-dump over 40 samples/bit, plus half-bit-offset
  integrators driving Gardner-style +/-1-sample clock nudges on
  transitions (packet.c:276-334);
- NRZI + bit-unstuffing + flag/abort detection + CRC-CCITT
  (packet.c:336-407).

The port's copy of ``ka9q_sdr_tpu.decode.afsk``, bit for bit.  Filtering
and tone mixdown are vectorised block math (numpy: this decoder runs at
48 kHz on the host, off the device); the bit-sync runs as an *event* loop at
~2400 events/s using prefix sums, not per-sample Python, and reproduces
the C sample-by-sample semantics exactly (variable 39/41-sample bits
after clock nudges included).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..ops.window import window_filter
from .ax25 import crc_good

__all__ = ["AFSKDemodulator", "afsk_modulate", "hdlc_encode"]

SAMPRATE = 48000
BITRATE = 1200
SAMPPBIT = SAMPRATE // BITRATE   # 40 (packet.c:48)
HALF = SAMPPBIT // 2
L = 1000                          # packet.c:44-50
M = 1049
N = L + M - 1                     # 2048
MARK = -1200.0
SPACE = -2200.0
MAX_FRAME = 1024                  # bytes (packet.c hdlc_frame)


def _analytic_response() -> np.ndarray:
    """+100..+4000 Hz analytic bandpass (set_filter on a COMPLEX slave of
    a REAL master, packet.c:273).  Full N-bin complex response, gain 1/N."""
    i = np.arange(N)
    f = np.where(i <= N // 2, i, i - N) * (SAMPRATE / N)
    resp = np.where((f >= 100.0) & (f <= 4000.0), 1.0 / N, 0.0).astype(
        np.complex128
    )
    return window_filter(L, M, resp, 3.0).astype(np.complex64)


def hdlc_encode(frame: bytes, preflags: int = 10, postflags: int = 3) -> list[int]:
    """Frame bytes (incl. CRC) -> HDLC bit stream: flags, LSB-first bits
    with zero-stuffing after five ones.  Inverse of the deframer for
    closed-loop tests (the reference tests by construction; SURVEY.md §4).
    """
    bits: list[int] = []
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    for _ in range(preflags):
        bits += flag
    ones = 0
    for byte in frame:
        for i in range(8):
            b = (byte >> i) & 1
            bits.append(b)
            if b:
                ones += 1
                if ones == 5:
                    bits.append(0)   # stuff
                    ones = 0
            else:
                ones = 0
    for _ in range(postflags):
        bits += flag
    return bits


def afsk_modulate(frame: bytes, amplitude: float = 0.5) -> np.ndarray:
    """AX.25 frame (incl. CRC) -> Bell-202 AFSK PCM at 48 kHz.

    NRZI: a 0 bit toggles the tone, a 1 bit holds it (matching the
    deframer's transition=zero convention, packet.c:332-407).  Tone
    switching is phase-continuous.
    """
    return modulate_bits(hdlc_encode(frame), amplitude)


def modulate_bits(bits: list[int], amplitude: float = 0.5) -> np.ndarray:
    """NRZI/AFSK-modulate a raw HDLC bit stream (for tests that need
    malformed streams: runts, aborts, shared-zero flags)."""
    tone = 1200.0
    phase = 0.0
    out = np.empty(len(bits) * SAMPPBIT, np.float32)
    idx = 0
    for b in bits:
        if b == 0:
            tone = 2200.0 if tone == 1200.0 else 1200.0
        dphi = 2.0 * np.pi * tone / SAMPRATE
        ph = phase + dphi * np.arange(1, SAMPPBIT + 1)
        out[idx : idx + SAMPPBIT] = amplitude * np.sin(ph)
        phase = ph[-1] % (2.0 * np.pi)
        idx += SAMPPBIT
    return out


class AFSKDemodulator:
    """Feed PCM floats in; complete CRC-good HDLC frames come back."""

    def __init__(self, on_frame: Optional[Callable[[bytes], None]] = None):
        self.on_frame = on_frame
        self.response = _analytic_response()
        self.overlap = np.zeros(M - 1, np.float32)
        self.pcm_buf = np.zeros(0, np.float32)
        self.sample_count = 0      # absolute sample index for NCO phase

        # integrate-and-dump state (packet.c:287-293)
        self.symphase = 0
        self.mark_accum = 0j
        self.space_accum = 0j
        self.mark_off = 0j
        self.space_off = 0j
        self.last_val = 0.0
        self.mid_val = 0.0

        # HDLC state (packet.c:296-300)
        self.frame = bytearray(MAX_FRAME)
        self._frame_zeros = bytes(MAX_FRAME)
        self.frame_bit = 0
        self.flagsync = False
        self.ones = 0
        self.frames: list[bytes] = []

    # ---- filter front end ----

    def _filter_block(self, block: np.ndarray) -> np.ndarray:
        """One REAL-master overlap-save step + analytic slave
        (execute_filter_input/output for packet.c's geometry)."""
        buf = np.concatenate([self.overlap, block])
        self.overlap = buf[L:].astype(np.float32)
        fdomain = np.fft.rfft(buf)
        h = N // 2
        # real in, complex out: negative-frequency bins are conjugates
        # (filter.c:209-216); response is full-spectrum
        pos = self.response[: h + 1] * fdomain
        neg = self.response[h + 1 :] * np.conj(fdomain[h - 1 : 0 : -1])
        f_fd = np.concatenate([pos, neg])
        y = np.fft.ifft(f_fd) * N
        return y[N - L :].astype(np.complex64)

    # ---- public feed ----

    def process(self, pcm: np.ndarray) -> list[bytes]:
        """Feed float PCM at 48 kHz; returns frames completed this call."""
        self.frames = []
        self.pcm_buf = np.concatenate([self.pcm_buf, np.asarray(pcm, np.float32)])
        while len(self.pcm_buf) >= L:
            block, self.pcm_buf = self.pcm_buf[:L], self.pcm_buf[L:]
            analytic = self._filter_block(block)
            n0 = self.sample_count
            self.sample_count += L
            k = n0 + np.arange(L)
            mark_lo = np.exp(2j * np.pi * (MARK / SAMPRATE) * k)
            space_lo = np.exp(2j * np.pi * (SPACE / SAMPRATE) * k)
            # _bit_loop drains its input fully (the partial-symbol tail is
            # integrated into the accumulators), so nothing carries over.
            self._bit_loop((analytic * mark_lo).astype(np.complex64),
                           (analytic * space_lo).astype(np.complex64))
        return self.frames

    # ---- integrate & dump / clock recovery (packet.c:305-334) ----

    def _bit_loop(self, mark: np.ndarray, space: np.ndarray) -> None:
        csm = np.concatenate([[0], np.cumsum(mark)])
        css = np.concatenate([[0], np.cumsum(space)])
        n = len(mark)
        i = 0
        while True:
            target = HALF if self.symphase < HALF else SAMPPBIT
            take = target - self.symphase
            if i + take > n:
                break
            seg_m = csm[i + take] - csm[i]
            seg_s = css[i + take] - css[i]
            self.mark_accum += seg_m
            self.space_accum += seg_s
            self.mark_off += seg_m
            self.space_off += seg_s
            i += take
            self.symphase = target
            if target == HALF:
                self.mid_val = abs(self.mark_off) ** 2 - abs(self.space_off) ** 2
                self.mark_off = 0j
                self.space_off = 0j
            else:
                cur_val = abs(self.mark_accum) ** 2 - abs(self.space_accum) ** 2
                self.mark_accum = 0j
                self.space_accum = 0j
                self.symphase = 0
                self._hdlc_bit(cur_val)
        # partial tail: integrate what remains
        if i < n:
            rem_m = csm[n] - csm[i]
            rem_s = css[n] - css[i]
            self.mark_accum += rem_m
            self.space_accum += rem_s
            self.mark_off += rem_m
            self.space_off += rem_s
            self.symphase += n - i

    # ---- NRZI / HDLC (packet.c:332-407) ----

    def _hdlc_bit(self, cur_val: float) -> None:
        if cur_val * self.last_val < 0:
            # transition: Gardner nudge + NRZI zero
            self.symphase += 1 if (cur_val - self.last_val) * self.mid_val > 0 else -1
            if self.ones == 6:
                # flag
                if self.flagsync:
                    self.frame_bit -= 7
                    nbytes = self.frame_bit // 8
                    if nbytes > 0 and crc_good(bytes(self.frame[:nbytes])):
                        frame = bytes(self.frame[:nbytes])
                        self.frames.append(frame)
                        if self.on_frame:
                            self.on_frame(frame)
                self._reset_frame()
                self.flagsync = True
            elif self.ones == 5:
                pass   # stuffed zero, drop
            elif self.ones < 5 and self.flagsync:
                self.frame_bit += 1
                if self.frame_bit >= 8 * MAX_FRAME:
                    self._reset_frame()
                    self.flagsync = False
            self.ones = 0
        else:
            # NRZI one
            self.ones += 1
            if self.ones == 7:
                self._reset_frame()
                self.flagsync = False
            elif self.flagsync:
                self.frame[self.frame_bit // 8] |= 1 << (self.frame_bit % 8)
                self.frame_bit += 1
                if self.frame_bit >= 8 * MAX_FRAME:
                    self._reset_frame()
                    self.flagsync = False
        self.last_val = cur_val

    def _reset_frame(self) -> None:
        # Full clear like the reference's memset (packet.c:380,397): this
        # runs AFTER the flag path's `frame_bit -= 7`, so a partial clear
        # bounded by frame_bit leaves stale 1-bits (or, when frame_bit
        # went negative on shared-zero flags, clears nothing) that OR
        # into — and CRC-kill — the next valid frame.
        self.frame[:] = self._frame_zeros
        self.frame_bit = 0
