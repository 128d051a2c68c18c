"""APRS position decoding and look-angle computation (aprs.c).

Parses timestamped, compressed (base-91) and MIC-E position reports,
converts WGS84 lat/long/alt to earth-centered coordinates and computes
azimuth/elevation/range from a configured station (aprs.c:105-135,
239-269) — the rotor-pointing math.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional

from .ax25 import AX25Frame, decode_base91

__all__ = [
    "parse_timestamp",
    "parse_position",
    "parse_mice_position",
    "parse_aprs",
    "Station",
    "look_angles",
]

WGS84_A = 6378137.0
WGS84_E = 0.081819190842622


def _ecef(lat_deg: float, lon_deg: float, alt_m: float):
    """WGS84 geodetic -> earth-centered rotating XYZ (aprs.c:112-121)."""
    sinlat = math.sin(math.radians(lat_deg))
    coslat = math.cos(math.radians(lat_deg))
    sinlon = math.sin(math.radians(lon_deg))
    coslon = math.cos(math.radians(lon_deg))
    tmp = WGS84_A / math.sqrt(1 - WGS84_E**2 * sinlat**2)
    x = (tmp + alt_m) * coslat * coslon
    y = (tmp + alt_m) * coslat * sinlon
    z = (tmp * (1 - WGS84_E**2) + alt_m) * sinlat
    return x, y, z


@dataclass
class Station:
    """Observer site with its local unit vectors (aprs.c:105-135)."""

    latitude: float
    longitude: float
    altitude: float = 0.0

    def __post_init__(self):
        sinlat = math.sin(math.radians(self.latitude))
        coslat = math.cos(math.radians(self.latitude))
        sinlon = math.sin(math.radians(self.longitude))
        coslon = math.cos(math.radians(self.longitude))
        self.xyz = _ecef(self.latitude, self.longitude, self.altitude)
        self.up = (coslon * coslat, sinlon * coslat, sinlat)
        self.east = (-sinlon, coslon, 0.0)
        # (verbatim from aprs.c:132-134, including its z expression)
        self.south = (
            coslon * sinlat,
            sinlon * sinlat,
            -(sinlon * sinlon * sinlat + coslon * coslon * coslat),
        )


def look_angles(
    station: Station, lat: float, lon: float, alt: float = 0.0
) -> tuple[float, float, float]:
    """(azimuth_deg, elevation_deg, range_m) from station to target
    (aprs.c:239-269)."""
    tx, ty, tz = _ecef(lat, lon, alt)
    sx, sy, sz = station.xyz
    lx, ly, lz = tx - sx, ty - sy, tz - sz
    rng = math.sqrt(lx * lx + ly * ly + lz * lz)
    if rng == 0.0:
        # target coincides with the station: the C's 0.0/0.0 yields nan
        # ("az nan") and keeps running (aprs.c:257-261); Python would
        # raise ZeroDivisionError and kill the daemon's receive loop
        return float("nan"), float("nan"), 0.0
    dot = lambda a: (a[0] * lx + a[1] * ly + a[2] * lz) / rng
    south = dot(station.south)
    east = dot(station.east)
    up = dot(station.up)
    elevation = math.asin(max(-1.0, min(1.0, up)))
    azimuth = math.pi - math.atan2(east, south)
    return math.degrees(azimuth), math.degrees(elevation), rng


def parse_timestamp(data: str):
    """DHM/HMS timestamp (parse_timestamp, aprs.c:275-312).  Returns
    (rest, days, hours, minutes, seconds) or (None, ...) on error."""
    m = re.match(r"(\d+)([hz/])", data)
    if not m:
        return None, -1, -1, -1, -1
    t = int(m.group(1))
    kind = m.group(2)
    rest = data[m.end():]
    if kind == "h":
        return rest, 0, t // 10000, (t // 100) % 100, t % 100
    # z (zulu) and / (local) both: DDHHMM
    return rest, t // 10000, (t // 100) % 100, t % 100, 0


def parse_position(data: str):
    """Uncompressed or compressed position (parse_position,
    aprs.c:314-351).  Returns (rest, lat, lon, alt) with NaN for unknown.
    """
    lat = lon = alt = float("nan")
    if not data:
        return None, lat, lon, alt
    if data[0] == "=":
        data = data[1:]
    if data and data[0] in "/!":
        # compressed base-91 (aprs.c:320-326)
        body = data[1:]
        if len(body) < 12:
            return None, lat, lon, alt
        lat = 90.0 - decode_base91(body[0:4]) / 380926.0
        lon = -180.0 + decode_base91(body[4:8]) / 190463.0
        return data[13:], lat, lon, alt
    m = re.match(r"(\d+(?:\.\d+)?)([NnSs])(.)", data)
    if not m:
        return None, lat, lon, alt
    v = float(m.group(1)) / 100.0
    lat = int(v) + math.fmod(v, 1.0) / 0.6   # ddmm.mm -> degrees
    if m.group(2).lower() == "s":
        lat = -lat
    data = data[m.end():]
    m = re.match(r"(\d+(?:\.\d+)?)([EeWw]).?", data, re.DOTALL)
    if not m:
        return None, lat, lon, alt
    v = float(m.group(1)) / 100.0
    lon = int(v) + math.fmod(v, 1.0) / 0.6
    if m.group(2).lower() == "w":
        lon = -lon
    # the reference skips the symbol-table char after W/E too
    # (aprs.c:339 "data = ncp + 2"), so the A= scan starts past it
    data = data[m.end():]
    # scan for A=xxxxxx altitude in feet (aprs.c:341-347)
    am = re.search(r"A=(-?\d+)", data)
    if am:
        alt = int(am.group(1)) * 0.3048
    return data, lat, lon, alt


def parse_mice_position(frame: AX25Frame, data: bytes):
    """MIC-E: latitude hidden in the destination callsign, longitude in
    the info field (parse_mice_position, aprs.c:352-383)."""
    if len(frame.dest_raw) < 7 or len(data) < 4:
        return None, float("nan"), float("nan")
    # The C indexes the *decoded ASCII* destination callsign
    # (aprs.c:357-381 uses frame->dest, filled by get_callsign).
    dd = [(b >> 1) & 0x7F for b in frame.dest_raw[:6]]
    deg = (dd[0] & 0xF) * 10 + (dd[1] & 0xF)
    minutes = (dd[2] & 0xF) * 10 + (dd[3] & 0xF)
    hun = (dd[4] & 0xF) * 10 + (dd[5] & 0xF)
    lat = deg + minutes / 60.0 + hun / 6000.0
    # (the reference applies no N/S sign to latitude)
    b = data[1:]
    ldeg = b[0] - 28
    if 180 <= ldeg <= 189:
        ldeg -= 80
    elif 190 <= ldeg <= 199:
        ldeg -= 190
    if dd[4] & 0x40:
        ldeg += 100
    lmin = b[1] - 28
    if lmin > 60:
        lmin -= 60
    lhun = b[2] - 28
    lon = ldeg + lmin / 60.0 + lhun / 6000.0
    if dd[3] & 0x40:
        lon = -lon   # aprs.c:380-381
    return data[4:], lat, lon


def parse_aprs(frame: AX25Frame) -> dict:
    """Dispatch on the APRS data-type byte (aprs.c:193-223).  Returns a
    dict with whatever was decodable: lat/lon/alt, timestamp, kind."""
    out: dict = {"kind": "other", "source": frame.source}
    info = frame.information.decode("ascii", "replace")
    if not info:
        return out
    c = info[0]
    lat = lon = alt = float("nan")
    if c in "/@":
        rest, days, hours, minutes, seconds = parse_timestamp(info[1:])
        out.update(days=days, hours=hours, minutes=minutes, seconds=seconds)
        if rest is not None:
            rest, lat, lon, alt = parse_position(rest)
            out["kind"] = "position"
    elif c in "!=":
        body = info[1:]
        if body.startswith("!"):
            out["kind"] = "weather"
            return out
        _, lat, lon, alt = parse_position(body)
        out["kind"] = "position"
    elif c in "`'":
        _, lat, lon = parse_mice_position(frame, frame.information)
        out["kind"] = "mice"
    if not math.isnan(lat):
        out["latitude"] = lat
        out["longitude"] = lon
        if not math.isnan(alt):
            out["altitude"] = alt
    return out
