"""Solid Earth tide displacement (degree-2, Sun + Moon).

The port's copy of gnss_sdr_tpu/receiver/pvt/tides.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: ``src/algorithms/libs/rtklib/rtklib_tides.cc``
(``tide_pl``/``tidedisp`` solid-tide part): the station displacement from
the degree-2 tidal potential of a body at unit direction ``e_b`` and
distance ``r_b`` is

  d = (GM_b / GM_E) * re^4 / r_b^3 *
      [ h2 * e_r * (1.5 (e_r.e_b)^2 - 0.5) + 3 l2 (e_r.e_b) (e_b - (e_r.e_b) e_r) ]

with nominal Love/Shida numbers h2=0.6078, l2=0.0847. Sun/Moon positions
come from the standard low-precision analytic series (rtklib sunmoonpos);
accuracy is a few arcminutes, plenty for the few-cm tide term. Used by the
PPP/RTK layers to correct the station coordinates.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.receiver.pvt.gpstime import gps_to_gpsdatetime

GM_EARTH = 3.986004418e14
GM_SUN = 1.32712440018e20
GM_MOON = 4.902800066e12
RE = 6_378_137.0
AU = 149_597_870_700.0
H2, L2 = 0.6078, 0.0847


def _julian_centuries(week: int, tow: float) -> float:
    t = gps_to_gpsdatetime(week, tow)
    jd = (367 * t.year - (7 * (t.year + (t.month + 9) // 12)) // 4
          + (275 * t.month) // 9 + t.day + 1721013.5
          + (t.hour + t.minute / 60.0 + t.second / 3600.0) / 24.0)
    return (jd - 2451545.0) / 36525.0


def _gmst_rad(week: int, tow: float) -> float:
    t = _julian_centuries(week, tow)
    gmst_s = (67310.54841 + (876600.0 * 3600 + 8640184.812866) * t
              + 0.093104 * t * t - 6.2e-6 * t ** 3)
    return np.deg2rad((gmst_s % 86400.0) / 240.0)


def sun_moon_ecef(week: int, tow: float) -> tuple[np.ndarray, np.ndarray]:
    """Low-precision Sun and Moon ECEF positions (m), rtklib sunmoonpos."""
    t = _julian_centuries(week, tow)
    d2r = np.deg2rad
    eps = d2r(23.43929111)          # obliquity

    # Sun (Astronomical Almanac low-precision)
    ms = d2r(357.5277233 + 35999.05034 * t) % (2 * np.pi)
    ls = d2r((280.460 + 36000.770 * t + 1.914666471 * np.sin(ms)
              + 0.019994643 * np.sin(2 * ms)) % 360.0)
    rs = AU * (1.000140612 - 0.016708617 * np.cos(ms)
               - 0.000139589 * np.cos(2 * ms))
    sun_eci = rs * np.array([np.cos(ls),
                             np.cos(eps) * np.sin(ls),
                             np.sin(eps) * np.sin(ls)])

    # Moon (truncated ELP series, rtklib coefficients)
    lm = d2r(218.32 + 481267.883 * t
             + 6.29 * np.sin(d2r(134.9 + 477198.85 * t))
             - 1.27 * np.sin(d2r(259.2 - 413335.38 * t))
             + 0.66 * np.sin(d2r(235.7 + 890534.23 * t))
             + 0.21 * np.sin(d2r(269.9 + 954397.70 * t))
             - 0.19 * np.sin(d2r(357.5 + 35999.05 * t))
             - 0.11 * np.sin(d2r(186.6 + 966404.05 * t)))
    pm = d2r(5.13 * np.sin(d2r(93.3 + 483202.03 * t))
             + 0.28 * np.sin(d2r(228.2 + 960400.87 * t))
             - 0.28 * np.sin(d2r(318.3 + 6003.18 * t))
             - 0.17 * np.sin(d2r(217.6 - 407332.20 * t)))
    rm = RE / np.sin(d2r(0.9508
                         + 0.0518 * np.cos(d2r(134.9 + 477198.85 * t))
                         + 0.0095 * np.cos(d2r(259.2 - 413335.38 * t))
                         + 0.0078 * np.cos(d2r(235.7 + 890534.23 * t))
                         + 0.0028 * np.cos(d2r(269.9 + 954397.70 * t))))
    moon_eci = rm * np.array([
        np.cos(pm) * np.cos(lm),
        np.cos(eps) * np.cos(pm) * np.sin(lm) - np.sin(eps) * np.sin(pm),
        np.sin(eps) * np.cos(pm) * np.sin(lm) + np.cos(eps) * np.sin(pm)])

    # ECI -> ECEF: rotate by GMST about z
    g = _gmst_rad(week, tow)
    rot = np.array([[np.cos(g), np.sin(g), 0.0],
                    [-np.sin(g), np.cos(g), 0.0],
                    [0.0, 0.0, 1.0]])
    return rot @ sun_eci, rot @ moon_eci


def _tide_body(rcv_ecef: np.ndarray, body_ecef: np.ndarray,
               gm_body: float) -> np.ndarray:
    r_r = np.linalg.norm(rcv_ecef)
    e_r = rcv_ecef / r_r
    r_b = np.linalg.norm(body_ecef)
    e_b = body_ecef / r_b
    k = gm_body / GM_EARTH * RE * (RE / r_b) ** 3
    c = float(e_r @ e_b)
    d_radial = k * H2 * (1.5 * c * c - 0.5)
    d_trans = k * 3.0 * L2 * c
    return d_radial * e_r + d_trans * (e_b - c * e_r)


def solid_tide_displacement(rcv_ecef: np.ndarray, week: int,
                            tow: float) -> np.ndarray:
    """Station displacement [3] ECEF meters from solid Earth tides."""
    sun, moon = sun_moon_ecef(week, tow)
    return (_tide_body(rcv_ecef, sun, GM_SUN)
            + _tide_body(rcv_ecef, moon, GM_MOON))
