"""aprsfeed — receive-only APRS i-gate (aprsfeed.c).

Joins the AX.25 multicast stream, converts UI frames to TNC2 monitor
strings, and uploads them over TCP to an APRS-IS server with the
callsign+hash passcode login (aprsfeed.c:95-115,162).  Drops
Internet-relayed (TCPIP path), third-party ('{' info) and empty frames
(aprsfeed.c:244-263).  Auto-reconnects with backoff.

Usage:
  python -m ka9q_sdr_tpu_torch.apps.aprsfeed -I 239.2.1.4:5004 -u N0CALL-1
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

from ..decode.ax25 import ax25_parse, frame_to_tnc2
from ..net.multicast import setup_mcast
from ..net.rtp import RTPHeader, AX25_PT, rtp_payload

__all__ = ["main", "aprs_passcode", "should_relay"]


def aprs_passcode(callsign: str) -> int:
    """The APRS-IS trivial hash authenticator (aprsfeed.c:96-111)."""
    call = callsign.split("-")[0].upper()
    hash_ = 0x73E2
    # the C reads pairs, indexing one past the end of odd-length strings
    # into the NUL terminator; emulate with a padded string
    padded = call + "\0"
    for i in range(0, len(call), 2):
        hash_ ^= ord(padded[i]) << 8
        hash_ ^= ord(padded[i + 1])
    return hash_ & 0x7FFF


def should_relay(frame) -> tuple[bool, str]:
    """Relay filter (aprsfeed.c:244-263)."""
    if frame is None:
        return False, "unparseable"
    if frame.control != 0x03 or frame.type != 0xF0:
        return False, "invalid ax25 ctl/protocol"
    if len(frame.information) == 0:
        return False, "empty I field"
    if any(name.upper().startswith("TCPIP") for name, _ in frame.digipeaters):
        return False, "Internet relayed packet"
    if frame.information[:1] == b"{":
        return False, "third party traffic"
    return True, ""


def build_parser() -> argparse.ArgumentParser:
    # add_help=False so -h can be the APRS-IS host, as in the reference
    # (aprsfeed.c getopt "u:p:I:vh:f:"); --help still works
    p = argparse.ArgumentParser(prog="aprsfeed", add_help=False)
    p.add_argument("--help", action="help",
                   help="show this help message and exit")
    p.add_argument("-I", "--input", required=True, help="AX.25 multicast")
    p.add_argument("-u", "--user", required=True, help="callsign[-ssid]")
    p.add_argument("-p", "--passcode", default=None)
    p.add_argument("-h", "-H", "--host", default="noam.aprs2.net",
                   help="APRS-IS server (aprsfeed.c -h)")
    p.add_argument("-P", "--port", default="14580")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print each frame decision to stderr")
    p.add_argument("-f", "--logfile", default=None,
                   help="append frame log lines to a file instead of "
                        "stderr (aprsfeed.c -f)")
    p.add_argument("--dry-run", action="store_true",
                   help="log what would be sent, no TCP connection")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.logfile:
        logf = open(args.logfile, "a", buffering=1)
    elif args.verbose or args.dry_run:
        logf = sys.stderr
    else:
        logf = None
    passcode = args.passcode or str(aprs_passcode(args.user))
    in_sock = setup_mcast(args.input, output=False)

    def start_drain(sock, dead, verbose):
        """Reader thread like the reference's netreader (aprsfeed.c:159,
        278-293): APRS-IS servers send a login response and periodic
        '# aprsc' keepalives; never reading them fills the kernel buffer
        until the server stalls and drops the 'unresponsive' client."""
        import threading

        def run():
            try:
                while True:
                    d = sock.recv(4096)
                    if not d:
                        break
                    if verbose:
                        sys.stderr.write(d.decode("ascii", "replace"))
            except OSError:
                pass
            dead.set()

        threading.Thread(target=run, daemon=True).start()

    import threading

    net = None
    net_dead = threading.Event()
    while True:
        if net is not None and net_dead.is_set():
            try:
                net.close()
            except OSError:
                pass
            net = None
            print("APRS-IS connection lost; reconnecting", file=sys.stderr)
        if net is None and not args.dry_run:
            try:
                net = socket.create_connection((args.host, int(args.port)), 30)
                login = f"user {args.user} pass {passcode} vers KA9Q-aprs 1.0\r\n"
                net.sendall(login.encode())
                print(f"connected to {args.host}:{args.port}", file=sys.stderr)
                net_dead = threading.Event()
                start_drain(net, net_dead, args.verbose)
            except OSError as e:
                print(f"APRS-IS connect failed: {e}; retrying", file=sys.stderr)
                net = None
                time.sleep(30)
                continue
        try:
            data = in_sock.recv(9000)
        except KeyboardInterrupt:
            return 0
        try:
            hdr, off = RTPHeader.from_bytes(data)
        except ValueError:
            continue
        if hdr.type != AX25_PT:
            continue
        frame = ax25_parse(rtp_payload(hdr, data, off))
        ok, why = should_relay(frame)
        mon = frame_to_tnc2(frame, qcall=args.user) if frame else ""
        if logf is not None:
            print(f" {mon}" if ok else f" Not relaying: {why}", file=logf)
        if not ok:
            continue
        if args.dry_run:
            continue
        try:
            net.sendall((mon + "\r\n").encode())
        except OSError:
            try:
                net.close()
            except OSError:
                pass
            net = None   # reconnect on next loop


if __name__ == "__main__":
    sys.exit(main())
