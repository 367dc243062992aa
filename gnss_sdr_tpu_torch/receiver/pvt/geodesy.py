"""Geodesy utilities: ECEF <-> geodetic, local ENU frames, az/el, DOP.

Reference analogs: ``src/algorithms/libs/geofunctions.cc`` and RTKLIB's
``ecef2pos``/``satazel`` in ``rtklib_rtkcmn.cc``. numpy float64 host math.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch import constants as C


def geodetic_to_ecef(lat_rad: float, lon_rad: float, h_m: float) -> np.ndarray:
    a, e2 = C.WGS84_A, C.WGS84_E2
    sl = np.sin(lat_rad)
    n = a / np.sqrt(1.0 - e2 * sl * sl)
    return np.array([
        (n + h_m) * np.cos(lat_rad) * np.cos(lon_rad),
        (n + h_m) * np.cos(lat_rad) * np.sin(lon_rad),
        (n * (1.0 - e2) + h_m) * sl,
    ])


def ecef_to_geodetic(xyz: np.ndarray) -> tuple[float, float, float]:
    """Iterative conversion; returns (lat_rad, lon_rad, height_m)."""
    a, e2 = C.WGS84_A, C.WGS84_E2
    x, y, z = float(xyz[0]), float(xyz[1]), float(xyz[2])
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    if p < 1e-9:
        lat = np.pi / 2 if z >= 0 else -np.pi / 2
        return lat, lon, abs(z) - a * np.sqrt(1 - e2)
    lat = np.arctan2(z, p * (1.0 - e2))
    for _ in range(8):
        sl = np.sin(lat)
        n = a / np.sqrt(1.0 - e2 * sl * sl)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - e2 * n / (n + h)))
    sl = np.sin(lat)
    n = a / np.sqrt(1.0 - e2 * sl * sl)
    h = p / np.cos(lat) - n
    return lat, lon, h


def enu_matrix(lat_rad: float, lon_rad: float) -> np.ndarray:
    """Rows are the East, North, Up unit vectors in ECEF."""
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    so, co = np.sin(lon_rad), np.cos(lon_rad)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


def ecef_to_enu(d_ecef: np.ndarray, lat_rad: float, lon_rad: float) -> np.ndarray:
    return enu_matrix(lat_rad, lon_rad) @ d_ecef


def enu_to_ecef_offset(enu: np.ndarray, lat_rad: float,
                       lon_rad: float) -> np.ndarray:
    """Local ENU displacement -> ECEF displacement (inverse of ecef_to_enu)."""
    return enu_matrix(lat_rad, lon_rad).T @ np.asarray(enu, np.float64)


def az_el(rcv_ecef: np.ndarray, sat_ecef: np.ndarray) -> tuple[float, float]:
    """Azimuth/elevation (rad) of satellite as seen from receiver."""
    lat, lon, _ = ecef_to_geodetic(rcv_ecef)
    enu = ecef_to_enu(sat_ecef - rcv_ecef, lat, lon)
    e, n, u = enu / np.linalg.norm(enu)
    az = np.arctan2(e, n) % (2 * np.pi)
    el = np.arcsin(u)
    return az, el


def dops(los_unit: np.ndarray, rcv_ecef: np.ndarray) -> dict:
    """GDOP/PDOP/HDOP/VDOP/TDOP from unit line-of-sight vectors [N,3]."""
    n = los_unit.shape[0]
    h = np.hstack([-los_unit, np.ones((n, 1))])
    q = np.linalg.inv(h.T @ h)
    lat, lon, _ = ecef_to_geodetic(rcv_ecef)
    r = enu_matrix(lat, lon)
    t = np.eye(4)
    t[:3, :3] = r
    q_local = t @ q @ t.T
    return dict(
        gdop=float(np.sqrt(np.trace(q))),
        pdop=float(np.sqrt(np.trace(q[:3, :3]))),
        hdop=float(np.sqrt(q_local[0, 0] + q_local[1, 1])),
        vdop=float(np.sqrt(q_local[2, 2])),
        tdop=float(np.sqrt(q[3, 3])),
    )
