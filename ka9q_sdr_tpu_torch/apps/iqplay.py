"""iqplay — replay I/Q recordings (or stdin) as an RTP multicast stream.

The hardware simulator (iqplay.c): lets the whole stack run with zero
radio hardware.  Emits IQ_PT packets of 240 samples (1.25 ms, 800 pkt/s,
funcube.c:72-75) with the legacy 24-byte status header, paced to real
time against the wall clock (iqplay.c:35-108).

Usage:
  python -m ka9q_sdr_tpu_torch.apps.iqplay -R 239.1.1.1:5004 rec.iq
  ... | python -m ka9q_sdr_tpu_torch.apps.iqplay -R 239.1.1.1:5004 -r 192000 -
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..net.multicast import setup_mcast
from ..net.rtp import RTPHeader, IQ_PT
from ..net.sdr_header import LegacyStatus
from ..io.iqfile import read_metadata
from ..utils.misc import UNIX_EPOCH_GPS, GPS_UTC_OFFSET

BLOCKSIZE = 240   # samples per packet (iqplay.c / funcube.c:72)


def play_stream(
    read_block,
    sock,
    samprate: int,
    frequency: float,
    realtime: bool = True,
    status_interval: int = 1,
):
    """Send packets from read_block() (returns one packet's worth of s16le
    I/Q bytes — default BLOCKSIZE samples, -b overrides — or b'' at EOF),
    pacing to the sample clock.  One read = one UDP datagram; the repo's
    receivers use 9000-byte buffers, so main() caps -b at 2048 samples."""
    seq = 0
    timestamp = 0
    samples = 0               # unwrapped: the 32-bit RTP timestamp wraps
    #                           in ~30 min at 2.4 Msps, which would
    #                           collapse pacing and the GPS status clock
    ssrc = int(time.time()) & 0xFFFFFFFF
    t0 = time.monotonic()
    sent = 0
    gps_ns = int((time.time() - UNIX_EPOCH_GPS + GPS_UTC_OFFSET) * 1e9)
    while True:
        data = read_block()
        if not data:
            return sent
        nsamp = len(data) // 4
        hdr = RTPHeader(type=IQ_PT, seq=seq, timestamp=timestamp, ssrc=ssrc)
        status = LegacyStatus(
            timestamp=gps_ns + int(samples * 1e9 / samprate),
            frequency=frequency,
            samprate=samprate,
        )
        sock.send(hdr.to_bytes() + status.to_bytes() + data)
        seq = (seq + 1) & 0xFFFF
        timestamp = (timestamp + nsamp) & 0xFFFFFFFF
        samples += nsamp
        sent += 1
        if realtime:
            # pace against the wall clock (iqplay.c gettimeofday pacing)
            due = t0 + samples / samprate
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)


def native_main(args) -> int:
    """Wire-rate replay through the C++ sender (native.RTPSender)."""
    import numpy as np

    from ..native import RTPSender
    from ..net.multicast import _parse_target

    host, port, iface = _parse_target(args.output)
    if iface and ":" in host and "%" not in host:
        host = f"{host}%{iface}"   # scope for link-local v6
    for path in args.files:
        attrs = read_metadata(path) if path != "-" else {}
        samprate = args.samprate or int(attrs.get("samplerate", 192000))
        freq = args.frequency or float(attrs.get("frequency", 0.0))
        tx = RTPSender(host, port, samprate=int(samprate),
                       frequency=freq, ttl=args.ttl)
        fh = sys.stdin.buffer if path == "-" else open(path, "rb")
        sent = 0
        while True:
            raw = fh.read(args.pkt_samples * 4 * 256)
            if not raw:
                if args.loop and path != "-":
                    fh.seek(0)
                    continue
                break
            iq = np.frombuffer(raw, "<i2")
            sent += tx.send(iq, pkt_samples=args.pkt_samples,
                            realtime=not args.fast)
        tx.close()
        if args.verbose:
            print(f"{path}: {sent} packets (native)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="iqplay")
    p.add_argument("-R", "--output", required=True, help="dest multicast name:port")
    p.add_argument("-r", "--samprate", type=int, default=0)
    p.add_argument("-f", "--frequency", type=float, default=0.0)
    p.add_argument("-T", "--ttl", type=int, default=1)
    p.add_argument("--fast", action="store_true", help="no real-time pacing")
    p.add_argument("--loop", action="store_true", help="loop the recording")
    p.add_argument("-l", "--locale", default=None,
                   help="numeric output locale (iqplay.c:143 -l; "
                        "best-effort)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-file progress to stderr (iqplay.c -v)")
    p.add_argument("-b", "--pkt-samples", dest="pkt_samples", type=int,
                   default=BLOCKSIZE,
                   help="samples per packet (iqplay.c:146 -b Blocksize)")
    p.add_argument("--native", action="store_true",
                   help="use the C++ sender (required beyond ~2 Msps)")
    p.add_argument("files", nargs="+", help="recordings, or - for stdin")
    args = p.parse_args(argv)
    from ..utils.misc import set_locale
    set_locale(args.locale)
    if not 1 <= args.pkt_samples <= 2048:
        # one read = one datagram; receivers here use recvfrom(9000).
        # Also guards <=0: read(-4) would slurp the whole file into one
        # (unsendable) datagram and 0 would loop sending nothing.
        clamped = min(max(args.pkt_samples, 1), 2048)
        print(f"iqplay: -b {args.pkt_samples} clamped to {clamped} samples "
              "(8 KiB datagrams)", file=sys.stderr)
        args.pkt_samples = clamped

    if args.native:
        return native_main(args)
    sock = setup_mcast(args.output, output=True, ttl=args.ttl)
    nread = args.pkt_samples * 4
    for path in args.files:
        if path == "-":
            samprate = args.samprate or 192000
            freq = args.frequency
            f = sys.stdin.buffer
            reader = lambda: f.read(nread)
        else:
            attrs = read_metadata(path)
            samprate = args.samprate or int(attrs.get("samplerate", 192000))
            freq = args.frequency or float(attrs.get("frequency", 0.0))
            fh = open(path, "rb")

            def reader(fh=fh):
                d = fh.read(nread)
                if not d and args.loop:
                    fh.seek(0)
                    d = fh.read(nread)
                return d

        n = play_stream(reader, sock, samprate, freq, realtime=not args.fast)
        if args.verbose:
            print(f"{path}: {n} packets", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
