"""GNSS almanac models: reduced-precision orbits for warm start.

Reference analogs: ``Gps_Almanac`` / ``Galileo_Almanac`` / the GNAV almanac
strings (``src/core/system_parameters/gps_almanac.h``,
``glonass_gnav_navigation_message.cc``), consumed by
``ControlThread::get_visible_sats`` (control_thread.cc:163) to predict
visible satellites and Doppler for assisted acquisition when no ephemeris
is available — the common real-world warm-start case (almanacs stay valid
for weeks, ephemerides for hours).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris

# IS-GPS-200: almanac inclination is an offset from the nominal 0.30
# semicircles (54 deg)
GPS_ALMANAC_I0_REF = 0.30 * C.PI_GPS


@dataclasses.dataclass
class GpsAlmanac:
    """One satellite's LNAV SF4/5 almanac page (IS-GPS-200 20.3.3.5.1.2).

    Angles in radians, ``delta_i`` relative to the 0.30-semicircle nominal.
    """

    prn: int = 0
    e: float = 0.0
    toa: float = 0.0           # [s of week]
    delta_i: float = 0.0       # [rad] offset from 54 deg
    omega_dot: float = 0.0     # [rad/s]
    sqrt_a: float = 0.0        # [m^0.5]
    omega0: float = 0.0        # [rad]
    omega: float = 0.0         # [rad]
    m0: float = 0.0            # [rad]
    af0: float = 0.0           # [s]
    af1: float = 0.0           # [s/s]
    health: int = 0
    wna: int = 0               # almanac reference week (8 LSBs)

    def to_ephemeris(self) -> KeplerEphemeris:
        """Reduced-precision KeplerEphemeris: the almanac IS a Kepler set
        with implicit zeros (no harmonic corrections, no delta_n/idot) and
        the nominal-inclination offset (reference Gps_Almanac usage in
        supl client / control thread visibility prediction)."""
        return KeplerEphemeris(
            prn=self.prn, week=self.wna, toc=self.toa, toe=self.toa,
            af0=self.af0, af1=self.af1,
            sqrt_a=self.sqrt_a, e=self.e, m0=self.m0,
            omega0=self.omega0, omega_dot=self.omega_dot, omega=self.omega,
            i0=GPS_ALMANAC_I0_REF + self.delta_i,
            health=self.health)

    @classmethod
    def from_ephemeris(cls, eph: KeplerEphemeris) -> "GpsAlmanac":
        """Reduce an ephemeris to its almanac projection (test oracle and
        the generator's source for SF4/5 pages).

        toa is transmitted in 2^12 s steps, so the reference epoch snaps to
        that grid and the epoch-dependent elements (m0, omega0, af0)
        propagate to the snapped epoch — otherwise the quantized toa would
        shift the mean anomaly by up to n*2048 s (thousands of km)."""
        toa = round(eph.toe / 4096.0) * 4096.0
        dt = toa - eph.toe
        n = np.sqrt(eph.gm) / eph.sqrt_a ** 3

        def wrap(x):
            return float((x + np.pi) % (2.0 * np.pi) - np.pi)

        return cls(prn=eph.prn, e=eph.e, toa=toa,
                   delta_i=eph.i0 - GPS_ALMANAC_I0_REF,
                   omega_dot=eph.omega_dot, sqrt_a=eph.sqrt_a,
                   omega0=wrap(eph.omega0 + eph.omega_dot * dt),
                   omega=eph.omega, m0=wrap(eph.m0 + n * dt),
                   af0=eph.af0 + eph.af1 * dt, af1=eph.af1,
                   health=eph.health, wna=eph.week & 0xFF)

    def position_velocity(self, t: float):
        return self.to_ephemeris().position_velocity(t)


# BDS ICD 5.2.4.15: almanac delta_i is relative to 0.30 semicircles for
# MEO/IGSO satellites and to 0 for GEO (PRN 1-5, 59-63)
BDS_ALMANAC_I0_REF = 0.30 * np.pi


def _bds_i_ref(prn: int) -> float:
    return 0.0 if (prn <= 5 or prn >= 59) else BDS_ALMANAC_I0_REF


@dataclasses.dataclass
class BeidouAlmanac:
    """One satellite's D1 almanac page (subframe 4 / subframe 5 pages 1-6,
    BDS ICD 5.2.4.14; reference beidou_dnav_navigation_message.cc case 4/5).
    Angles in radians; ``delta_i`` relative to the orbit-type nominal."""

    prn: int = 0
    sqrt_a: float = 0.0        # [m^0.5] (absolute, unlike Galileo)
    e: float = 0.0
    delta_i: float = 0.0       # [rad] offset from 54 deg (MEO/IGSO) or 0 (GEO)
    toa: float = 0.0           # [s of week], 4096 s steps on air
    omega0: float = 0.0        # [rad]
    omega: float = 0.0         # [rad]
    m0: float = 0.0            # [rad]
    omega_dot: float = 0.0     # [rad/s]
    af0: float = 0.0           # [s]
    af1: float = 0.0           # [s/s]
    wna: int = 0               # almanac week (8 bits, from SF5 page 8)
    health: int = 0

    def to_ephemeris(self) -> KeplerEphemeris:
        return KeplerEphemeris(
            prn=self.prn, week=self.wna, toc=self.toa, toe=self.toa,
            af0=self.af0, af1=self.af1,
            sqrt_a=self.sqrt_a, e=self.e, m0=self.m0,
            omega0=self.omega0, omega_dot=self.omega_dot, omega=self.omega,
            i0=_bds_i_ref(self.prn) + self.delta_i,
            health=self.health, gm=C.GM_EARTH_BDS)

    @classmethod
    def from_ephemeris(cls, eph: KeplerEphemeris) -> "BeidouAlmanac":
        """Almanac projection (toa snaps to the 4096 s broadcast grid with
        epoch-dependent elements propagated, as in GpsAlmanac)."""
        toa = round(eph.toe / 4096.0) * 4096.0
        dt = toa - eph.toe
        n = np.sqrt(eph.gm) / eph.sqrt_a ** 3

        def wrap(x):
            return float((x + np.pi) % (2.0 * np.pi) - np.pi)

        return cls(prn=eph.prn, sqrt_a=eph.sqrt_a, e=eph.e,
                   delta_i=eph.i0 - _bds_i_ref(eph.prn),
                   toa=toa,
                   omega0=wrap(eph.omega0 + eph.omega_dot * dt),
                   omega=eph.omega, m0=wrap(eph.m0 + n * dt),
                   omega_dot=eph.omega_dot,
                   af0=eph.af0 + eph.af1 * dt, af1=eph.af1,
                   wna=eph.week & 0xFF, health=eph.health)

    def position_velocity(self, t: float):
        return self.to_ephemeris().position_velocity(t)


# Galileo OS SIS ICD 5.1.10: the almanac broadcasts differences from the
# nominal orbit — sqrt(A_nom) with A_nom = 29 600 000 m and i_nom = 56 deg
GAL_ALMANAC_SQRT_A_REF = float(np.sqrt(29_600_000.0))
GAL_ALMANAC_I0_REF = float(np.deg2rad(56.0))


@dataclasses.dataclass
class GalileoAlmanac:
    """One satellite's I/NAV almanac (words 7-10, three SVIDs per IODa set).

    Angles in radians; ``delta_sqrt_a`` and ``delta_i`` are offsets from
    the ICD nominal orbit (reference ``Galileo_Almanac_Helper`` fields,
    galileo_navigation_message.cc:565).
    """

    svid: int = 0
    delta_sqrt_a: float = 0.0  # [m^0.5] offset from sqrt(29600 km)
    e: float = 0.0
    delta_i: float = 0.0       # [rad] offset from 56 deg
    omega0: float = 0.0        # [rad]
    omega_dot: float = 0.0     # [rad/s]
    omega: float = 0.0         # [rad]
    m0: float = 0.0            # [rad]
    af0: float = 0.0           # [s]
    af1: float = 0.0           # [s/s]
    ioda: int = 0
    wna: int = 0               # almanac week (2 LSBs of WN on air)
    toa: float = 0.0           # [s of week], 600 s steps on air
    e5b_hs: int = 0
    e1b_hs: int = 0

    @property
    def prn(self) -> int:      # uniform key for the almanac stores
        return self.svid

    @property
    def health(self) -> int:
        return self.e1b_hs

    def to_ephemeris(self) -> KeplerEphemeris:
        return KeplerEphemeris(
            prn=self.svid, week=self.wna, toc=self.toa, toe=self.toa,
            af0=self.af0, af1=self.af1,
            sqrt_a=GAL_ALMANAC_SQRT_A_REF + self.delta_sqrt_a,
            e=self.e, m0=self.m0,
            omega0=self.omega0, omega_dot=self.omega_dot, omega=self.omega,
            i0=GAL_ALMANAC_I0_REF + self.delta_i,
            health=self.e1b_hs, gm=C.GM_EARTH_GAL)

    @classmethod
    def from_ephemeris(cls, eph: KeplerEphemeris, ioda: int = 1
                       ) -> "GalileoAlmanac":
        """Almanac projection of an ephemeris (generator/test oracle);
        toa snaps to the 600 s broadcast grid with the epoch-dependent
        elements propagated to the snapped epoch (same reasoning as
        GpsAlmanac.from_ephemeris)."""
        toa = round(eph.toe / 600.0) * 600.0
        dt = toa - eph.toe
        n = np.sqrt(eph.gm) / eph.sqrt_a ** 3

        def wrap(x):
            return float((x + np.pi) % (2.0 * np.pi) - np.pi)

        return cls(svid=eph.prn,
                   delta_sqrt_a=eph.sqrt_a - GAL_ALMANAC_SQRT_A_REF,
                   e=eph.e, delta_i=eph.i0 - GAL_ALMANAC_I0_REF,
                   omega0=wrap(eph.omega0 + eph.omega_dot * dt),
                   omega_dot=eph.omega_dot, omega=eph.omega,
                   m0=wrap(eph.m0 + n * dt),
                   af0=eph.af0 + eph.af1 * dt, af1=eph.af1,
                   ioda=ioda, wna=eph.week & 0x3, toa=toa,
                   e5b_hs=0, e1b_hs=0)

    def position_velocity(self, t: float):
        return self.to_ephemeris().position_velocity(t)


@dataclasses.dataclass
class GlonassAlmanac:
    """GNAV almanac for one slot (GLONASS ICD 4.5, strings 6-15 in pairs).

    Keeps the broadcast parameters; ``freq_slot`` (H_n - the FDMA channel)
    is the operationally-critical field for a warm start: it tells the
    receiver WHERE in frequency each slot transmits without any tracking.
    """

    slot: int = 0              # n_A
    freq_slot: int = 0         # H_n, FDMA channel number k in [-7, 6]
    health: int = 1            # C_n (1 = healthy)
    lambda_n: float = 0.0      # [rad] longitude of first ascending node
    t_lambda: float = 0.0      # [s of day] time of that node passage
    delta_i: float = 0.0       # [rad] offset from nominal 63 deg
    ecc: float = 0.0
    omega_n: float = 0.0       # [rad] argument of perigee
    delta_t: float = 0.0       # [s] draconitic period offset from 43200 s
    delta_t_dot: float = 0.0   # [s/orbit]
    tau_n: float = 0.0         # [s] coarse clock correction

    # nominal GLONASS orbit constants (ICD appendix 3.2.2)
    I_NOM = np.deg2rad(63.0)
    T_NOM = 43200.0

    def semi_major_axis(self) -> float:
        """Axis from the draconitic period (Kepler's third law on the
        corrected period; the J2 refinement iterates this — the first-order
        value is within ~25 km, plenty for Doppler prediction)."""
        t_dr = self.T_NOM + self.delta_t
        return float((C.GM_EARTH * (t_dr / (2.0 * np.pi)) ** 2) ** (1.0 / 3.0))

    def position_velocity(self, t_sod: float):
        """Coarse PZ-90 position/velocity at GLONASS seconds-of-day
        ``t_sod`` — Kepler propagation from the ascending-node epoch with
        the Earth-fixed node longitude rotated to the evaluation time.
        Accuracy ~km over hours: amply inside an assisted-acquisition
        Doppler window (reference: the control thread only needs coarse
        elevation/Doppler from almanacs)."""
        a = self.semi_major_axis()
        # mean anomaly from the ascending node: at the node, the argument
        # of latitude is 0, so the true anomaly is -omega
        nu0 = -self.omega_n
        e0 = 2.0 * np.arctan(np.sqrt((1 - self.ecc) / (1 + self.ecc))
                             * np.tan(nu0 / 2.0))
        m_node = e0 - self.ecc * np.sin(e0)
        kep = KeplerEphemeris(
            prn=self.slot, toc=self.t_lambda, toe=self.t_lambda,
            sqrt_a=np.sqrt(a), e=self.ecc, m0=m_node,
            # Earth-fixed node longitude acts as omega0 with the Earth
            # rotation folded back out by the standard omega_e * toe term
            omega0=self.lambda_n + C.OMEGA_EARTH_DOT_GLO * self.t_lambda,
            omega=self.omega_n, i0=self.I_NOM + self.delta_i,
            gm=C.GM_EARTH, omega_e=C.OMEGA_EARTH_DOT_GLO)
        return kep.position_velocity(t_sod)
