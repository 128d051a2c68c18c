"""opusd — PCM to Opus multicast transcoder daemon (opus.c; port of
``ka9q_sdr_tpu.apps.opusd``).

Joins a PCM group, transcodes each (sender, SSRC) session to Opus at the
configured bitrate/frame size, and multicasts OPUS_PT RTP to the output
group.

By default the hot loop runs in the native engine (rtp_engine.cc
opus_tx_*): recvmmsg, session demux, resequencing, encode and send in one
C++ thread, so the interpreter does no per-packet work.  --py forces the
pure-Python path (held byte-identical to the engine by
tests/test_torch_audio.py).  Only the engine's construction may fall back
to the Python loop; that is host transport, not the card (this daemon
never uses one).

Usage:
  python -m ka9q_sdr_tpu_torch.apps.opusd -I 239.2.1.1:5004 \\
      -R 239.2.1.3:5004 -o 32000 --dtx
"""

from __future__ import annotations

import argparse
import sys
import time

from ..audio.opus_codec import OPUS_AVAILABLE
from ..audio.transcode import OpusTranscoder
from ..net.multicast import setup_mcast, _parse_target


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="opusd")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--output", required=True)
    p.add_argument("-o", "--bitrate", type=int, default=32000)  # opus.c:59
    p.add_argument("-B", "--frame-ms", type=float, default=20.0)
    p.add_argument("-x", "--dtx", action="store_true")
    p.add_argument("-f", "--fec", type=int, default=0, metavar="LOSS_PC",
                   help="enable inband FEC for an expected packet-loss "
                        "percentage (opus.c:95-96,232-239)")
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the native engine's counters to stderr "
                        "every 0.5 s (opus.c -v)")
    p.add_argument("--py", action="store_true",
                   help="force the pure-Python transcode loop")
    p.add_argument("--max-sessions", type=int, default=1024,
                   help="native engine session cap (hostile-SSRC flood "
                        "guard)")
    p.add_argument("--complexity", type=int, default=-1,
                   help="Opus encoder complexity 0-10 (-1 = libopus "
                        "default, like the reference); lower trades "
                        "quality for encoder CPU (extension; opus.c never "
                        "sets it)")
    p.add_argument("--packets", type=int, default=0)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="exit after this long (native path; 0 = forever)")
    args = p.parse_args(argv)

    if not OPUS_AVAILABLE:
        print("libopus not available", file=sys.stderr)
        return 1

    if not args.py:
        # Only engine CONSTRUCTION may fall back to the Python loop; a
        # runtime error from an already-running engine must propagate --
        # silently restarting as Python would reset every encoder session
        # and all output streams.
        eng = None
        try:
            from ..native import NativeOpusTranscoder

            in_host, in_port, in_if = _parse_target(args.input)
            out_host, out_port, out_if = _parse_target(args.output)
            if in_if and ":" in in_host and "%" not in in_host:
                in_host = f"{in_host}%{in_if}"   # scope for link-local v6
            if out_if and ":" in out_host and "%" not in out_host:
                out_host = f"{out_host}%{out_if}"
            # names resolve dual-stack inside the wrapper
            eng = NativeOpusTranscoder(
                in_host, out_host, in_port, out_port,
                bitrate=args.bitrate, frame_ms=args.frame_ms, dtx=args.dtx,
                fec=args.fec, ttl=args.ttl,
                max_sessions=args.max_sessions,
                complexity=args.complexity,
            )
        except (OSError, ImportError) as e:
            print(f"native engine unavailable ({e}); falling back to the "
                  f"Python loop", file=sys.stderr)
        if eng is not None:
            t0 = time.monotonic()
            try:
                while True:
                    time.sleep(0.5)
                    s = eng.stats()
                    if args.verbose:
                        print(s, file=sys.stderr, flush=True)
                    if args.packets and s["packets_in"] >= args.packets:
                        return 0
                    if args.seconds and time.monotonic() - t0 >= args.seconds:
                        return 0
            except KeyboardInterrupt:
                return 0
            finally:
                eng.close()

    in_sock = setup_mcast(args.input, output=False)
    out_sock = setup_mcast(args.output, output=True, ttl=args.ttl)
    tc = OpusTranscoder(
        send=lambda d: out_sock.send(d),
        max_sessions=args.max_sessions,
        bitrate=args.bitrate,
        frame_ms=args.frame_ms,
        dtx=args.dtx,
        fec=args.fec,
    )
    n = 0
    t0 = time.monotonic()
    try:
        while True:
            data, sender = in_sock.recvfrom(9000)
            tc.feed_packet(data, sender)
            n += 1
            if args.packets and n >= args.packets:
                return 0
            if args.seconds and time.monotonic() - t0 >= args.seconds:
                return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
