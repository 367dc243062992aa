"""NMEA-0183 sentence output (GGA, RMC, GSA, GSV); a copy of
gnss_sdr_tpu/receiver/pvt/nmea.py.

Reference analog: ``Nmea_Printer``
(``src/algorithms/PVT/libs/nmea_printer.cc`` — which emits
GPGGA/GPGSA/GPGSV/GPRMC)."""

from __future__ import annotations

import math
import pathlib

from gnss_sdr_tpu_torch.receiver.pvt.gpstime import gps_to_datetime


def _checksum(body: str) -> str:
    c = 0
    for ch in body:
        c ^= ord(ch)
    return f"{c:02X}"


def _sentence(body: str) -> str:
    return f"${body}*{_checksum(body)}\r\n"


def _lat_str(lat_rad: float) -> tuple[str, str]:
    lat = math.degrees(lat_rad)
    hemi = "N" if lat >= 0 else "S"
    lat = abs(lat)
    deg = int(lat)
    minutes = (lat - deg) * 60.0
    return f"{deg:02d}{minutes:010.7f}", hemi


def _lon_str(lon_rad: float) -> tuple[str, str]:
    lon = math.degrees(lon_rad)
    hemi = "E" if lon >= 0 else "W"
    lon = abs(lon)
    deg = int(lon)
    minutes = (lon - deg) * 60.0
    return f"{deg:03d}{minutes:010.7f}", hemi


def gga(sol) -> str:
    t = gps_to_datetime(sol.week, sol.tow_s)
    lat, ns = _lat_str(sol.lat_rad)
    lon, ew = _lon_str(sol.lon_rad)
    body = (f"GPGGA,{t:%H%M%S}.{int(t.microsecond/1e4):02d},{lat},{ns},"
            f"{lon},{ew},1,{sol.n_sats:02d},{sol.hdop:.1f},"
            f"{sol.height_m:.1f},M,0.0,M,,")
    return _sentence(body)


def rmc(sol) -> str:
    t = gps_to_datetime(sol.week, sol.tow_s)
    lat, ns = _lat_str(sol.lat_rad)
    lon, ew = _lon_str(sol.lon_rad)
    import numpy as np
    ve, vn = sol.vel_ecef[0], sol.vel_ecef[1]  # approx; proper ENU below
    from gnss_sdr_tpu_torch.receiver.pvt.geodesy import ecef_to_enu
    enu = ecef_to_enu(np.asarray(sol.vel_ecef), sol.lat_rad, sol.lon_rad)
    speed_kt = float(np.hypot(enu[0], enu[1])) * 1.9438445
    course = math.degrees(math.atan2(enu[0], enu[1])) % 360.0
    body = (f"GPRMC,{t:%H%M%S}.{int(t.microsecond/1e4):02d},A,{lat},{ns},"
            f"{lon},{ew},{speed_kt:.2f},{course:.2f},{t:%d%m%y},,,A")
    return _sentence(body)


def gsa(sol, prns=()) -> str:
    ids = ",".join(f"{p:02d}" for p in list(prns)[:12])
    ids = ids + "," * (11 - min(len(list(prns)), 12) + (0 if prns else 0))
    fields = list(prns)[:12] + [""] * (12 - min(len(list(prns)), 12))
    ids = ",".join(f"{p:02d}" if p != "" else "" for p in fields)
    body = f"GPGSA,A,3,{ids},{sol.pdop:.1f},{sol.hdop:.1f},{sol.vdop:.1f}"
    return _sentence(body)


def gsv(sats) -> list[str]:
    """GPGSV satellites-in-view sentences (nmea_printer.cc GSV block):
    up to 4 satellites per sentence, each (prn, el_deg, az_deg, cn0_dbhz);
    cn0 may be None (tracked but no measurement -> empty SNR field)."""
    sats = list(sats)
    if not sats:
        return []
    n_msg = (len(sats) + 3) // 4
    out = []
    for m in range(n_msg):
        group = sats[4 * m: 4 * m + 4]
        fields = [f"GPGSV,{n_msg},{m + 1},{len(sats):02d}"]
        for prn, el, az, cn0 in group:
            snr = "" if cn0 is None else f"{int(round(cn0)):02d}"
            fields.append(f"{int(prn):02d},{int(round(el)):02d},"
                          f"{int(round(az)) % 360:03d},{snr}")
        # incomplete final group: pad with empty 4-field satellite slots
        # (the conventional GSV form, e.g. "...,00,,,,*4D")
        fields.extend(",,," for _ in range(4 - len(group)))
        out.append(_sentence(",".join(fields)))
    return out


def sats_in_view(sol, ephemerides, cn0_by_prn=None):
    """(prn, el_deg, az_deg, cn0) rows for gsv() from a solution + the
    GPS ephemeris store (keys ("G", prn) or bare prn)."""
    import numpy as np
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy

    rows = []
    for key, eph in sorted(ephemerides.items(),
                           key=lambda kv: kv[0][1]
                           if isinstance(kv[0], tuple) else kv[0]):
        if isinstance(key, tuple):
            if key[0] != "G":
                continue
            prn = key[1]
        else:
            prn = key
        try:
            pos, _vel = eph.position_velocity(sol.tow_s)
        except Exception:
            continue
        az, el = geodesy.az_el(np.asarray(sol.pos_ecef), np.asarray(pos))
        if el < 0:
            continue
        cn0 = (cn0_by_prn or {}).get(prn)
        rows.append((prn, math.degrees(el), math.degrees(az), cn0))
    return rows


class NmeaPrinter:
    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._f = open(self.path, "w")

    def push(self, sol, prns=(), ephemerides=None, cn0_by_prn=None) -> None:
        if not sol.valid:
            return
        self._f.write(gga(sol))
        self._f.write(rmc(sol))
        if prns:
            self._f.write(gsa(sol, prns))
        if ephemerides:
            for s in gsv(sats_in_view(sol, ephemerides, cn0_by_prn)):
                self._f.write(s)
        self._f.flush()

    def close(self) -> None:
        self._f.close()
