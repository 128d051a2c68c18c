"""pcmcat — PCM RTP multicast stream to raw s16 on stdout (pcmcat.c; port
of ``ka9q_sdr_tpu.apps.pcmcat``).

First SSRC wins (pcmcat.c:117-195); mono<->stereo up/downmix to the
requested channel count; big-endian wire samples converted to host order;
a gap in the RTP timestamps is written as silence (up to one second).

Usage:
  python -m ka9q_sdr_tpu_torch.apps.pcmcat 239.2.1.1:5004 > audio.s16
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..net.multicast import setup_mcast
from ..net.rtp import (RTPHeader, RTPState, rtp_process, rtp_payload,
                       PCM_MONO_PT, PCM_STEREO_PT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pcmcat")
    p.add_argument("group", help="PCM multicast name:port")
    p.add_argument("-2", "--stereo", action="store_true",
                   help="force stereo output (duplicate mono)")
    p.add_argument("-1", "--mono", action="store_true",
                   help="force mono output (average stereo)")
    p.add_argument("-s", "--ssrc", type=lambda v: int(v, 0), default=0,
                   help="play only this SSRC (pcmcat.c -s; 0x prefix for "
                        "hex); default: first SSRC wins")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="accepted for reference compatibility")
    p.add_argument("--packets", type=int, default=0, help="stop after N")
    args = p.parse_args(argv)

    sock = setup_mcast(args.group, output=False)
    state = RTPState()
    ssrc = args.ssrc or None
    out = sys.stdout.buffer
    n = 0
    try:
        while True:
            data = sock.recv(9000)
            try:
                hdr, off = RTPHeader.from_bytes(data)
            except ValueError:
                continue
            if hdr.type not in (PCM_MONO_PT, PCM_STEREO_PT):
                continue
            if ssrc is None:
                ssrc = hdr.ssrc          # first SSRC wins (pcmcat.c:117)
            elif hdr.ssrc != ssrc:
                continue
            payload = rtp_payload(hdr, data, off)
            channels = 1 if hdr.type == PCM_MONO_PT else 2
            # truncate ragged tails instead of crashing in np.frombuffer
            payload = payload[: len(payload) // (2 * channels)
                              * (2 * channels)]
            frames = len(payload) // (2 * channels)
            ts = rtp_process(state, hdr, frames)
            if ts < 0:
                continue      # duplicate/old packet (pcmcat.c:158-159)
            samples = np.frombuffer(payload, ">i2").astype(np.int16)
            if ts > 0:
                # fill the gap with silence to preserve timing
                out.write(bytes(2 * channels * min(ts, 48000)))
            want = 2 if args.stereo else 1 if args.mono else channels
            if want == channels:
                pass
            elif want == 2:   # mono -> stereo
                samples = np.repeat(samples, 2)
            else:             # stereo -> mono
                samples = ((samples[0::2].astype(np.int32)
                            + samples[1::2].astype(np.int32))
                           // 2).astype(np.int16)
            out.write(samples.tobytes())
            out.flush()
            n += 1
            if args.packets and n >= args.packets:
                return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
