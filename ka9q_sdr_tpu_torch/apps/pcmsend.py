"""pcmsend — raw audio on stdin to PCM RTP multicast (pcmsend.c).

The reference captures from portaudio; with no capture device in this
target, stdin carries s16 host-order stereo (or mono) at 48 kHz.  Frames
go out as 480-word PCM RTP packets paced to real time.

Usage:
  ... | python -m ka9q_sdr_tpu_torch.apps.pcmsend -R 239.2.1.9:5004
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io.pcm import PCMOutput
from ..net.multicast import setup_mcast

SAMPRATE = 48000
FRAME = 240   # stereo frames per packet = 480 words (pcmsend.c)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pcmsend")
    p.add_argument("-R", "--output", required=True)
    p.add_argument("-1", "--mono", action="store_true")
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("--fast", action="store_true", help="no pacing")
    p.add_argument("-I", dest="audiodev", default=None,
                   help="capture device (pcmsend.c -I); n/a in this target — "
                        "audio comes from stdin")
    p.add_argument("-L", "--list-audio", action="store_true",
                   help="list audio devices (pcmsend.c -L); none here")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="accepted for reference compatibility")
    args = p.parse_args(argv)
    from ..utils.misc import audio_device_notice
    if audio_device_notice(p.prog, args.list_audio, args.audiodev,
                           "capture", "s16 audio comes from stdin"):
        return 0

    sock = setup_mcast(args.output, output=True, ttl=args.ttl)
    out = PCMOutput(send=sock.send, ssrc=int(time.time()) & 0xFFFFFFFF)
    channels = 1 if args.mono else 2
    frame_bytes = FRAME * 2 * channels
    stdin = sys.stdin.buffer
    t0 = time.monotonic()
    sent = 0
    while True:
        raw = stdin.read(frame_bytes)
        if not raw:
            return 0
        audio = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
        if channels == 2:
            out.send_stereo(audio.reshape(-1, 2))
        else:
            out.send_mono(audio)
        sent += len(audio) // channels
        if not args.fast:
            due = t0 + sent / SAMPRATE
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)


if __name__ == "__main__":
    sys.exit(main())
