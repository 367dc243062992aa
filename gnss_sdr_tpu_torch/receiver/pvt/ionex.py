"""IONEX global ionosphere map reader + slant-delay provider.

The port's copy of gnss_sdr_tpu/receiver/pvt/ionex.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: ``src/algorithms/libs/rtklib/rtklib_ionex.cc``
(readtec/iontec): IONEX 1.0 TEC maps on a lat/lon grid at fixed epochs;
the slant delay at a frequency comes from bilinear interpolation in space,
linear interpolation in time, a thin-shell obliquity factor at the pierce
point, and 40.3e16/f^2 meters per TECU.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

RE_M = 6_371_000.0           # mean Earth radius used by IONEX
TECU_M_HZ2 = 40.3e16         # delay [m] = TECU_M_HZ2 * TEC / f^2


@dataclasses.dataclass
class IonexMaps:
    epochs_s: np.ndarray      # [T] seconds of (GPS) day/week — monotonic
    lats_deg: np.ndarray      # [NLAT] grid latitudes (descending allowed)
    lons_deg: np.ndarray      # [NLON]
    tec: np.ndarray           # [T, NLAT, NLON] TECU
    height_km: float = 450.0

    def vtec(self, t_s: float, lat_deg: float, lon_deg: float) -> float:
        """Time + bilinear spatial interpolation of vertical TEC."""
        e = self.epochs_s
        i = int(np.clip(np.searchsorted(e, t_s), 1, len(e) - 1))
        a = 0.0 if e[i] == e[i - 1] else (t_s - e[i - 1]) / (e[i] - e[i - 1])
        a = float(np.clip(a, 0.0, 1.0))

        def interp(map2d):
            lats = self.lats_deg
            lons = self.lons_deg
            # support descending latitude grids (the IONEX default)
            if lats[0] > lats[-1]:
                lats = lats[::-1]
                map2d = map2d[::-1]
            li = int(np.clip(np.searchsorted(lats, lat_deg), 1, len(lats) - 1))
            u = (lat_deg - lats[li - 1]) / (lats[li] - lats[li - 1])
            u = float(np.clip(u, 0.0, 1.0))
            m = map2d
            lon = (lon_deg - lons[0]) % 360.0 + lons[0]
            if lon > lons[-1]:
                # pierce point in the wrap seam: interpolate between the
                # last column and the first column at +360 degrees
                span = lons[0] + 360.0 - lons[-1]
                v = float(np.clip((lon - lons[-1]) / span, 0.0, 1.0))
                col_a = (1 - u) * m[li - 1, -1] + u * m[li, -1]
                col_b = (1 - u) * m[li - 1, 0] + u * m[li, 0]
                return (1 - v) * col_a + v * col_b
            gi = int(np.clip(np.searchsorted(lons, lon), 1, len(lons) - 1))
            v = (lon - lons[gi - 1]) / (lons[gi] - lons[gi - 1])
            v = float(np.clip(v, 0.0, 1.0))
            return ((1 - u) * (1 - v) * m[li - 1, gi - 1]
                    + (1 - u) * v * m[li - 1, gi]
                    + u * (1 - v) * m[li, gi - 1]
                    + u * v * m[li, gi])

        return (1 - a) * interp(self.tec[i - 1]) + a * interp(self.tec[i])

    def slant_delay_m(self, t_s: float, lat_rad: float, lon_rad: float,
                      az_rad: float, el_rad: float,
                      freq_hz: float = 1_575_420_000.0) -> float:
        """Slant ionospheric delay (m) via the thin-shell pierce point."""
        h = self.height_km * 1e3
        # Earth-central angle receiver -> pierce point
        psi = np.pi / 2 - el_rad - np.arcsin(
            RE_M / (RE_M + h) * np.cos(el_rad))
        lat_pp = np.arcsin(np.sin(lat_rad) * np.cos(psi)
                           + np.cos(lat_rad) * np.sin(psi) * np.cos(az_rad))
        lon_pp = lon_rad + np.arcsin(
            np.sin(psi) * np.sin(az_rad) / max(np.cos(lat_pp), 1e-6))
        vtec = self.vtec(t_s, np.degrees(lat_pp), np.degrees(lon_pp))
        # obliquity (mapping) factor
        f_ob = 1.0 / np.sqrt(max(
            1.0 - (RE_M / (RE_M + h) * np.cos(el_rad)) ** 2, 1e-6))
        return TECU_M_HZ2 * vtec * 1e16 / freq_hz ** 2 * f_ob / 1e16


def read_ionex(path) -> IonexMaps:
    """Parse an IONEX 1.0 file (TEC maps only)."""
    lines = pathlib.Path(path).read_text().splitlines()
    i = 0
    exponent = -1
    height_km = 450.0
    lat1 = lat2 = dlat = lon1 = lon2 = dlon = None
    while "END OF HEADER" not in lines[i]:
        lab = lines[i][60:].strip()
        if lab == "EXPONENT":
            exponent = int(lines[i].split()[0])
        elif lab == "HGT1 / HGT2 / DHGT":
            height_km = float(lines[i].split()[0])
        elif lab == "LAT1 / LAT2 / DLAT":
            lat1, lat2, dlat = map(float, lines[i].split()[:3])
        elif lab == "LON1 / LON2 / DLON":
            lon1, lon2, dlon = map(float, lines[i].split()[:3])
        i += 1
    lats = np.arange(lat1, lat2 + 0.5 * dlat, dlat)
    lons = np.arange(lon1, lon2 + 0.5 * dlon, dlon)
    epochs, maps = [], []
    i += 1
    cur = None
    while i < len(lines):
        lab = lines[i][60:].strip()
        if lab == "START OF TEC MAP":
            cur = np.zeros((len(lats), len(lons)))
        elif lab == "EPOCH OF CURRENT MAP":
            y, mo, d, h, mi, s = map(int, lines[i].split()[:6])
            epochs.append(h * 3600.0 + mi * 60.0 + s + (d - 1) * 86400.0)
        elif lab == "LAT/LON1/LON2/DLON/H":
            lat = float(lines[i][2:8])
            li = int(round((lat - lat1) / dlat))
            vals = []
            while len(vals) < len(lons):
                i += 1
                vals.extend(int(lines[i][k: k + 5])
                            for k in range(0, len(lines[i].rstrip()), 5))
            cur[li, :] = np.array(vals[: len(lons)], float) * 10.0 ** exponent
        elif lab == "END OF TEC MAP":
            maps.append(cur)
        i += 1
    return IonexMaps(epochs_s=np.asarray(epochs), lats_deg=lats,
                     lons_deg=lons, tec=np.stack(maps), height_km=height_km)


def write_ionex(path, maps: IonexMaps) -> None:
    """Minimal IONEX 1.0 writer (test oracle / interchange)."""
    L = []
    L.append(f"{1.0:8.1f}            IONOSPHERE MAPS     GPS"
             f"{'':20s}IONEX VERSION / TYPE")
    L.append(f"{'gnss_sdr_tpu':<60s}PGM / RUN BY / DATE")
    L.append(f"{-1:6d}{'':54s}EXPONENT")
    L.append(f"{maps.height_km:8.1f}{maps.height_km:6.1f}{0.0:6.1f}{'':40s}"
             "HGT1 / HGT2 / DHGT")
    L.append(f"{maps.lats_deg[0]:8.1f}{maps.lats_deg[-1]:6.1f}"
             f"{maps.lats_deg[1] - maps.lats_deg[0]:6.1f}{'':40s}"
             "LAT1 / LAT2 / DLAT")
    L.append(f"{maps.lons_deg[0]:8.1f}{maps.lons_deg[-1]:6.1f}"
             f"{maps.lons_deg[1] - maps.lons_deg[0]:6.1f}{'':40s}"
             "LON1 / LON2 / DLON")
    L.append(f"{'':60s}END OF HEADER")
    for t_i, tec in zip(maps.epochs_s, maps.tec):
        L.append(f"{'':60s}START OF TEC MAP")
        d = int(t_i // 86400) + 1
        rem = t_i % 86400
        h, mi, s = int(rem // 3600), int(rem % 3600 // 60), int(rem % 60)
        L.append(f"  2024     1{d:6d}{h:6d}{mi:6d}{s:6d}{'':24s}"
                 "EPOCH OF CURRENT MAP")
        for li, lat in enumerate(maps.lats_deg):
            L.append(f"  {lat:6.1f}{maps.lons_deg[0]:6.1f}"
                     f"{maps.lons_deg[-1]:6.1f}"
                     f"{maps.lons_deg[1] - maps.lons_deg[0]:6.1f}"
                     f"{maps.height_km:6.1f}{'':28s}LAT/LON1/LON2/DLON/H")
            vals = np.round(tec[li] / 10.0 ** -1).astype(int)
            for k in range(0, len(vals), 16):
                L.append("".join(f"{v:5d}" for v in vals[k: k + 16]))
        L.append(f"{'':60s}END OF TEC MAP")
    L.append(f"{'':60s}END OF FILE")
    pathlib.Path(path).write_text("\n".join(L) + "\n")
