"""aprs — APRS position monitor with rotor look angles (aprs.c).

Joins the AX.25 multicast stream, parses APRS position reports
(timestamped / compressed / MIC-E), and prints lat/long/alt plus
azimuth/elevation/range from the configured station — the rotor-pointing
output (aprs.c:239-269).

Usage:
  python -m ka9q_sdr_tpu_torch.apps.aprs -I 239.2.1.4:5004 \\
      --lat 32.88 --lon -117.24 --alt 120 [-s N0CALL]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from ..decode.ax25 import ax25_parse
from ..decode.aprs import Station, look_angles, parse_aprs
from ..net.multicast import setup_mcast
from ..net.rtp import RTPHeader, AX25_PT, rtp_payload


def format_report(frame, info: dict, station: Station | None) -> str:
    t = time.strftime("%d %b %Y %H:%M:%S UTC", time.gmtime())
    out = f"{t} {frame.source}:"
    if info.get("kind") in ("position", "mice") and "latitude" in info:
        lat, lon = info["latitude"], info["longitude"]
        out += f" Lat {lat:.6f} Long {lon:.6f}"
        alt = info.get("altitude")
        if alt is not None:
            out += f" Alt {alt:.1f} m"
        if station is not None:
            az, el, rng = look_angles(station, lat, lon, alt or 0.0)
            if alt is not None:
                out += f"; az {az:.1f} elev {el:.1f} range {rng:,.1f} m"
            else:
                out += f"; az {az:.1f} range {rng:,.1f} m"
    else:
        out += " " + frame.information.decode("ascii", "replace").rstrip()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="aprs")
    p.add_argument("-I", "--input", required=True, help="AX.25 multicast")
    p.add_argument("--lat", type=float, help="station latitude, degrees")
    p.add_argument("--lon", type=float, help="station longitude, degrees")
    p.add_argument("--alt", type=float, default=0.0, help="altitude, m")
    p.add_argument("-s", "--source", help="watch only this callsign")
    p.add_argument("--packets", type=int, default=0)
    args = p.parse_args(argv)

    station = None
    if args.lat is not None and args.lon is not None:
        station = Station(args.lat, args.lon, args.alt)
        print(f"Station coordinates: latitude {args.lat:.6f} deg; "
              f"longitude {args.lon:.6f} deg; altitude {args.alt:.1f} m")
    if args.source:
        print(f"Watching only {args.source}")

    sock = setup_mcast(args.input, output=False)
    n = 0
    try:
        while True:
            data = sock.recv(4096)
            try:
                hdr, off = RTPHeader.from_bytes(data)
            except ValueError:
                continue
            if hdr.type != AX25_PT:
                continue
            frame = ax25_parse(rtp_payload(hdr, data, off))
            if frame is None:
                continue
            if args.source and frame.source.upper() != args.source.upper():
                continue
            if frame.control != 0x03 or frame.type != 0xF0:
                print(f"{frame.source}: Invalid ax25 type", flush=True)
                continue
            info = parse_aprs(frame)
            print(format_report(frame, info, station), flush=True)
            n += 1
            if args.packets and n >= args.packets:
                return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
