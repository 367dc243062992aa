"""Precise observation-model corrections for PPP.

The port's copy of gnss_sdr_tpu/receiver/pvt/corrections.py
(numpy host code, imports rewritten to the port's modules).

Reference analogs in rtklib: ``windupcorr`` (rtklib_ppp.cc carrier phase
wind-up), ``satantoff`` (rtklib_preceph.cc satellite antenna phase-center
offset) and ``readpcv``/``antmodel`` (rtklib_rtkcmn.cc receiver ANTEX
PCO/PCV). On real data these are cm-to-dm effects that decide whether
PPP-AR fixes at all; the plain broadcast/observables chain does not need
them (broadcast ephemerides are referenced to the antenna phase center).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C

AU_M = 1.495978707e11


def sun_position_ecef(t_gps_week_s: float, week_start_gmst_rad: float = 0.0
                      ) -> np.ndarray:
    """Low-precision solar position in ECEF [m].

    Standard almanac formulas (Meeus/USNO low-precision series, the same
    fidelity class as rtklib's ``sunmoonpos``): ecliptic longitude series
    truncated to the two leading terms (~0.01 deg), rotated into ECEF via
    GMST. The time argument is seconds into the GPS week; absolute epoch
    enters through ``week_start_gmst_rad`` (GMST at the week start) plus a
    J2000-referenced mean anomaly — for the wind-up correction only the
    slow GEOMETRY of the sun direction matters, not arcsecond accuracy.
    """
    # days since J2000 assuming a contemporary epoch; the constant offset
    # only rotates the sun direction, which cancels in windup RATES and is
    # adequate for the cm-level windup/antenna terms
    d = t_gps_week_s / 86400.0
    g = np.deg2rad((357.529 + 0.98560028 * d) % 360.0)     # mean anomaly
    q = np.deg2rad((280.459 + 0.98564736 * d) % 360.0)     # mean longitude
    lam = q + np.deg2rad(1.915) * np.sin(g) \
        + np.deg2rad(0.020) * np.sin(2.0 * g)
    r = AU_M * (1.00014 - 0.01671 * np.cos(g) - 0.00014 * np.cos(2.0 * g))
    eps = np.deg2rad(23.439 - 0.00000036 * d)
    # equatorial inertial
    x = r * np.cos(lam)
    y = r * np.cos(eps) * np.sin(lam)
    z = r * np.sin(eps) * np.sin(lam)
    # GMST: 280.46 deg at the reference epoch + sidereal rate
    gmst = week_start_gmst_rad + np.deg2rad(
        (280.46061837 + 360.98564736629 * d) % 360.0)
    cg, sg = np.cos(gmst), np.sin(gmst)
    return np.array([cg * x + sg * y, -sg * x + cg * y, z])


def satellite_body_axes(sat_pos: np.ndarray, sun_pos: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Nominal yaw-steering body axes (ex, ey, ez) in ECEF: ez to the
    Earth's center, ey = ez x (sun direction), ex completing right-handed
    (IGS convention; rtklib satantoff/windupcorr)."""
    ez = -sat_pos / np.linalg.norm(sat_pos)
    es = (sun_pos - sat_pos)
    es = es / np.linalg.norm(es)
    ey = np.cross(ez, es)
    ey = ey / np.linalg.norm(ey)
    ex = np.cross(ey, ez)
    return ex, ey, ez


def phase_windup_cycles(sat_pos: np.ndarray, sun_pos: np.ndarray,
                        rcv_pos: np.ndarray, lat_rad: float, lon_rad: float,
                        prev_cycles: float | None = None) -> float:
    """Carrier phase wind-up in cycles (Wu et al. 1993; rtklib
    windupcorr): the phase rotation between the satellite's rotating
    dipole (body x/y axes) and the receiver's local ENU dipole, continuous
    against ``prev_cycles`` (the correction accumulates full turns as the
    geometry rotates)."""
    ex, ey, _ez = satellite_body_axes(sat_pos, sun_pos)
    k = (rcv_pos - sat_pos)
    k = k / np.linalg.norm(k)

    # receiver dipole: local east/north
    sl, cl = np.sin(lon_rad), np.cos(lon_rad)
    sp, cp = np.sin(lat_rad), np.cos(lat_rad)
    e_east = np.array([-sl, cl, 0.0])
    e_north = np.array([-sp * cl, -sp * sl, cp])

    # effective dipoles projected on the plane normal to k
    ds = ex - k * (k @ ex) - np.cross(k, ey)
    dr = e_east - k * (k @ e_east) + np.cross(k, e_north)
    cosp = (ds @ dr) / (np.linalg.norm(ds) * np.linalg.norm(dr))
    cosp = np.clip(cosp, -1.0, 1.0)
    ph = np.arccos(cosp) / (2.0 * np.pi)
    if (k @ np.cross(ds, dr)) < 0.0:
        ph = -ph
    if prev_cycles is not None:
        # phase continuity: keep within half a cycle of the previous value
        ph += np.round(prev_cycles - ph)
    return float(ph)


# nominal L1/L2 iono-free satellite antenna PCOs in the body frame [m]
# (z toward Earth). Per-block values come from ANTEX in real processing;
# this default is the Block IIF-class magnitude (reference: rtklib uses
# ANTEX pcvs, falling back to zero).
DEFAULT_SAT_PCO_BODY_M = np.array([0.394, 0.0, 1.6])


def satellite_antenna_offset(sat_pos: np.ndarray, sun_pos: np.ndarray,
                             pco_body_m: np.ndarray | None = None
                             ) -> np.ndarray:
    """ECEF offset from the satellite's center of mass to its antenna
    phase center (rtklib_preceph.cc satantoff): precise (SP3) orbits are
    CoM-referenced, so PHASE-CENTER positions = CoM + this offset."""
    pco = DEFAULT_SAT_PCO_BODY_M if pco_body_m is None else pco_body_m
    ex, ey, ez = satellite_body_axes(sat_pos, sun_pos)
    return pco[0] * ex + pco[1] * ey + pco[2] * ez


@dataclasses.dataclass
class ReceiverAntenna:
    """Receiver antenna model (ANTEX PCO + elevation-dependent PCV).

    ``pco_enu_m``: phase-center offset in local ENU meters (e/n/up).
    ``pcv_zen_deg``/``pcv_m``: zenith-angle grid and phase-center
    variations (meters); linear interpolation (rtklib antmodel).
    """

    pco_enu_m: tuple = (0.0, 0.0, 0.0)
    pcv_zen_deg: tuple = ()
    pcv_m: tuple = ()

    def correction_m(self, az_rad: float, el_rad: float) -> float:
        """Range correction [m] to ADD to the modeled range: the projection
        of the PCO on the line of sight plus the PCV at this elevation."""
        e = np.array([np.sin(az_rad) * np.cos(el_rad),
                      np.cos(az_rad) * np.cos(el_rad),
                      np.sin(el_rad)])
        d = float(np.asarray(self.pco_enu_m) @ e)
        if self.pcv_zen_deg:
            zen = 90.0 - np.degrees(el_rad)
            d += float(np.interp(zen, self.pcv_zen_deg, self.pcv_m))
        return d


def parse_antex_receiver(path, antenna_type: str | None = None,
                         freq: str = "G01") -> ReceiverAntenna:
    """Minimal ANTEX 1.4 reader for a receiver antenna: NORTH/EAST/UP PCO
    and the NOAZI PCV row of one frequency (rtklib readpcv role)."""
    pco = (0.0, 0.0, 0.0)
    pcv_zen: tuple = ()
    pcv: tuple = ()
    in_ant = antenna_type is None
    in_freq = False
    zen1 = zen2 = dzen = None
    with open(path) as f:
        for line in f:
            label = line[60:].strip()
            if label == "TYPE / SERIAL NO":
                name = line[:20].strip()
                in_ant = antenna_type is None or name == antenna_type
            elif not in_ant:
                continue
            elif label == "ZEN1 / ZEN2 / DZEN":
                zen1, zen2, dzen = (float(line[2:8]), float(line[8:14]),
                                    float(line[14:20]))
            elif label == "START OF FREQUENCY":
                in_freq = line[3:6].strip() == freq
            elif label == "END OF FREQUENCY":
                in_freq = False
            elif in_freq and label == "NORTH / EAST / UP":
                n, e, u = (float(line[0:10]), float(line[10:20]),
                           float(line[20:30]))
                pco = (e * 1e-3, n * 1e-3, u * 1e-3)   # mm -> m, ENU order
            elif in_freq and line.strip().startswith("NOAZI"):
                vals = [float(v) * 1e-3 for v in line.split()[1:]]
                if zen1 is not None:
                    pcv_zen = tuple(np.arange(zen1, zen2 + dzen / 2, dzen))
                    pcv = tuple(vals[: len(pcv_zen)])
    return ReceiverAntenna(pco_enu_m=pco, pcv_zen_deg=pcv_zen, pcv_m=pcv)
