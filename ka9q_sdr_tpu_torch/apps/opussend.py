"""opussend — raw audio on stdin to Opus RTP multicast (opussend.c; port
of ``ka9q_sdr_tpu.apps.opussend``).

pcmsend through the Opus encoder: s16 host-order stereo at 48 kHz on
stdin, 20 ms Opus frames out, paced to real time.  Options mirror
opussend.c:71-120 / opus.c.

Usage:
  ... | python -m ka9q_sdr_tpu_torch.apps.opussend -R 239.2.1.9:5004 \\
      -o 32000
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..audio.opus_codec import OPUS_AVAILABLE, OpusEncoder
from ..net.multicast import setup_mcast
from ..net.rtp import RTPHeader, OPUS_PT
from ..utils.misc import audio_device_notice

SAMPRATE = 48000


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="opussend")
    p.add_argument("-R", "--output", required=True)
    p.add_argument("-o", "--bitrate", type=int, default=32000)
    p.add_argument("-B", "--frame-ms", type=float, default=20.0)
    p.add_argument("-x", "--dtx", action="store_true")
    p.add_argument("-f", "--fec", type=int, default=0, metavar="LOSS_PC",
                   help="enable inband FEC for an expected packet-loss "
                        "percentage (opussend.c:113-114,239-246)")
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("--fast", action="store_true")
    p.add_argument("-I", dest="audiodev", default=None,
                   help="capture device (opussend.c -I); n/a in this target — "
                        "audio comes from stdin")
    p.add_argument("-L", "--list-audio", action="store_true",
                   help="list audio devices (opussend.c -L); none here")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="accepted for reference compatibility")
    args = p.parse_args(argv)
    if audio_device_notice(p.prog, args.list_audio, args.audiodev,
                           "capture", "s16 audio comes from stdin"):
        return 0

    if not OPUS_AVAILABLE:
        print("libopus not available", file=sys.stderr)
        return 1
    sock = setup_mcast(args.output, output=True, ttl=args.ttl)
    enc = OpusEncoder(SAMPRATE, 2, args.bitrate, dtx=args.dtx, fec=args.fec)
    frame = int(SAMPRATE * args.frame_ms / 1000)
    seq = 0
    timestamp = 0
    ssrc = int(time.time()) & 0xFFFFFFFF
    silent = True
    stdin = sys.stdin.buffer
    t0 = time.monotonic()
    sent = 0      # unwrapped sample count for pacing (ts wraps in ~24.8 h)
    while True:
        raw = stdin.read(frame * 4)   # stereo s16
        if not raw:
            return 0
        pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
        if len(pcm) < frame * 2:
            pcm = np.pad(pcm, (0, frame * 2 - len(pcm)))
        packet = enc.encode(pcm.reshape(-1, 2))
        ts = timestamp
        timestamp = (timestamp + frame) & 0xFFFFFFFF
        if len(packet) > 2:   # DTX suppression
            hdr = RTPHeader(type=OPUS_PT, seq=seq, timestamp=ts,
                            ssrc=ssrc, marker=silent)
            silent = False
            seq = (seq + 1) & 0xFFFF
            sock.send(hdr.to_bytes() + packet)
        else:
            silent = True
        sent += frame
        if not args.fast:
            due = t0 + sent / SAMPRATE
            d = due - time.monotonic()
            if d > 0:
                time.sleep(d)


if __name__ == "__main__":
    sys.exit(main())
