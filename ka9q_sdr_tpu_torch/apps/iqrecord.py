"""iqrecord — record RTP I/Q or PCM sessions to files (iqrecord.c).

One file per (sender, SSRC) session, headerless s16 with xattr metadata;
RTP timestamp gaps become sparse-file holes preserving sample timing.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.iqrecord -I 239.1.1.1:5004 -D /tmp/recs

Reference flags: -I input, -d duration (seconds of recorded stream
time), -l locale, -q quiet (iqrecord.c:96-110); the output directory is
-D/--directory here (the reference records into its cwd).
"""

from __future__ import annotations

import argparse
import sys

from ..net.multicast import setup_mcast
from ..net.rtp import (RTPHeader, rtp_payload, IQ_PT, IQ_PT8,
                       PCM_MONO_PT, PCM_STEREO_PT)
from ..net.sdr_header import LegacyStatus, LEGACY_STATUS_SIZE
from ..io.iqfile import IQRecorder


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="iqrecord")
    p.add_argument("-I", "--input", required=True, help="multicast name:port")
    p.add_argument("-d", "--duration", type=float, default=0.0,
                   help="stop after recording N seconds of stream time "
                        "(iqrecord.c:106,159 -d)")
    p.add_argument("-D", "--directory", default=".")
    p.add_argument("-l", "--locale", default=None,
                   help="numeric output locale (reference -l; accepted "
                        "for drop-in compatibility)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress display (reference -q; we print nothing "
                        "either way)")
    p.add_argument("--packets", type=int, default=0, help="stop after N")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.misc import set_locale
    set_locale(args.locale)

    sock = setup_mcast(args.input, output=False)
    sessions: dict[tuple, IQRecorder] = {}
    n = 0
    t_rec = 0.0            # recorded stream time (iqrecord.c:303)
    try:
        while True:
            data, sender = sock.recvfrom(9000)
            try:
                hdr, off = RTPHeader.from_bytes(data)
            except ValueError:
                continue
            if hdr.type not in (IQ_PT, IQ_PT8, PCM_MONO_PT, PCM_STEREO_PT):
                continue
            payload = rtp_payload(hdr, data, off)
            freq = 0.0
            if hdr.type in (IQ_PT, IQ_PT8):
                samprate = 192000
                # legacy status header carries frequency/rate (iqrecord.c)
                if len(payload) >= LEGACY_STATUS_SIZE:
                    status = LegacyStatus.from_bytes(payload)
                    if status.samprate:
                        samprate = status.samprate
                        freq = status.frequency
                    payload = payload[LEGACY_STATUS_SIZE:]
            else:
                samprate = 48000      # PCM sessions (iqrecord.c:213-219)
            key = (sender[0], hdr.ssrc)
            rec = sessions.get(key)
            if rec is None:
                rec = IQRecorder(
                    directory=args.directory,
                    frequency=freq,
                    samprate=samprate,
                    source=sender[0],
                    multicast=args.input,
                )
                sessions[key] = rec
            written = rec.write_packet(hdr, payload)
            n += 1
            # count only frames that landed on disk: duplicates are dropped
            # (not rewritten like iqrecord.c:300), so -d must not count them
            t_rec += written / rec.samprate
            if args.duration and t_rec >= args.duration:
                return 0
            if args.packets and n >= args.packets:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        for rec in sessions.values():
            rec.close()


if __name__ == "__main__":
    sys.exit(main())
