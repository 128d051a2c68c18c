"""packetd — AFSK/AX.25 packet demodulator daemon (packet.c).

Joins a PCM multicast group, runs an AFSK-1200 demodulator per
(sender, SSRC) session, and multicasts CRC-good HDLC frames as AX25_PT
RTP (packet.c:359-374).  -v dumps decoded frames.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.packetd -I 239.2.1.1:5004 \\
      -R 239.2.1.4:5004 -v

The port's copy of ``ka9q_sdr_tpu.apps.packetd``: the AFSK modem runs on
the host at 48 kHz.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..decode.afsk import AFSKDemodulator
from ..decode.ax25 import ax25_parse, frame_to_tnc2
from ..net.multicast import setup_mcast
from ..net.rtp import (
    RTPHeader,
    RTPState,
    rtp_process,
    rtp_payload,
    AX25_PT,
    PCM_MONO_PT,
    PCM_STEREO_PT,
)

SCALE = 1.0 / 32767.0


class PacketSession:
    def __init__(self, ssrc: int, out_send, verbose: bool = False):
        self.rtp_in = RTPState()
        self.out = RTPState(ssrc=ssrc)
        self.out_send = out_send
        self.verbose = verbose
        self.decoded = 0
        self.demod = AFSKDemodulator()

    def feed(self, hdr: RTPHeader, payload: bytes) -> None:
        channels = 1 if hdr.type == PCM_MONO_PT else 2
        # truncate ragged tails instead of crashing in np.frombuffer
        payload = payload[: len(payload) // (2 * channels) * (2 * channels)]
        frames = len(payload) // (2 * channels)
        if rtp_process(self.rtp_in, hdr, frames) < 0:
            return   # dupes; gaps are ignored (packet.c:202-203)
        pcm = np.frombuffer(payload, ">i2").astype(np.float32) * SCALE
        if channels == 2:
            pcm = pcm[0::2]   # left channel
        for frame in self.demod.process(pcm):
            self.decoded += 1
            if self.verbose:
                f = ax25_parse(frame)
                if f:
                    print(
                        f"ssrc {self.out.ssrc:x} packet {self.decoded} "
                        f"len {len(frame)}: {frame_to_tnc2(f)}",
                        file=sys.stderr,
                        flush=True,
                    )
            out_hdr = RTPHeader(
                type=AX25_PT,
                seq=self.out.seq,
                timestamp=self.out.timestamp,
                ssrc=self.out.ssrc,
            )
            self.out.seq = (self.out.seq + 1) & 0xFFFF
            self.out.timestamp = (self.out.timestamp + len(frame)) & 0xFFFFFFFF
            self.out.packets += 1
            self.out_send(out_hdr.to_bytes() + frame)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="packetd")
    p.add_argument("-I", "--input", required=True, action="append",
                   help="PCM multicast (repeatable)")
    p.add_argument("-R", "--output", required=True, help="AX.25 multicast")
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--packets", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import select

    socks = [setup_mcast(g, output=False) for g in args.input]
    out_sock = setup_mcast(args.output, output=True, ttl=args.ttl)
    sessions: dict[tuple, PacketSession] = {}
    n = 0
    try:
        while True:
            ready, _, _ = select.select(socks, [], [], 1.0)
            for s in ready:
                data, sender = s.recvfrom(9000)
                try:
                    hdr, off = RTPHeader.from_bytes(data)
                except ValueError:
                    continue
                if hdr.type not in (PCM_MONO_PT, PCM_STEREO_PT):
                    continue
                key = (sender[0], hdr.ssrc)
                sess = sessions.get(key)
                if sess is None:
                    sess = PacketSession(hdr.ssrc, out_sock.send, args.verbose)
                    sessions[key] = sess
                sess.feed(hdr, rtp_payload(hdr, data, off))
                n += 1
                if args.packets and n >= args.packets:
                    return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
