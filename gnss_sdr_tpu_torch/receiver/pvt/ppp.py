"""Precise Point Positioning (static and kinematic, float ambiguities).

The port's copy of gnss_sdr_tpu/receiver/pvt/ppp.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: ``src/algorithms/libs/rtklib/rtklib_ppp.cc`` (pppos): a
sequential filter over iono-free code + carrier observations with precise
orbits/clocks (see sp3.py), estimating position (constant in static mode, a
random walk in kinematic mode — RTKLIB ``udpos_ppp`` PMODE_PPP_KINEMA),
receiver clock (white noise), residual zenith tropospheric delay (random
walk) and one float iono-free ambiguity per satellite, with cycle-slip
resets of the affected ambiguity state (``udbias_ppp``/``detecs``).

State: x = [p(3), c*dt, T_z, N_1..N_m] (N in meters of iono-free phase).
Measurements per satellite per epoch:
  PR_IF  = rho + c*dt + m(el) * T_z            + eps_pr
  PHI_IF = rho + c*dt + m(el) * T_z + N_i      + eps_phi
Host numpy float64; runs at the PVT rate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.receiver.pvt.solver import _eph_lookup, _rotate_sat


@dataclasses.dataclass
class PppObs:
    prn: int
    system: str
    t_tx_sv: float
    pr_if_m: float              # iono-free pseudorange
    phase_if_m: float           # iono-free carrier phase (meters)


@dataclasses.dataclass
class PppSolution:
    valid: bool
    pos_ecef: np.ndarray = None
    clock_bias_m: float = 0.0
    ztd_m: float = 0.0
    n_sats: int = 0
    sigma_pos_m: float = 0.0


def tropo_mapping(el: float) -> float:
    """Simple 1/sin(el) wet mapping function."""
    return 1.0 / max(np.sin(el), 0.05)


class PppFilter:
    """Static PPP sequential filter (extended Kalman form)."""

    def __init__(self, ephemerides: dict, x0_ecef: np.ndarray,
                 sigma_pr_m: float = 1.0, sigma_phase_m: float = 0.01,
                 q_clk: float = 1e8, q_ztd: float = 1e-8,
                 mode: str = "static", q_pos_m2_s: float = 1.0,
                 estimate_tropo: bool = True):
        self.ephemerides = ephemerides
        self.sigma_pr = sigma_pr_m
        self.sigma_ph = sigma_phase_m
        self.q_clk = q_clk
        self.q_ztd = q_ztd
        # kinematic (RTKLIB PMODE_PPP_KINEMA): position random walk with
        # spectral density q_pos_m2_s per axis; static: position constant
        self.mode = mode
        self.q_pos = q_pos_m2_s
        self.sat_index: dict[tuple, int] = {}
        n = 5
        self.x = np.zeros(n)
        self.x[:3] = x0_ecef
        # estimate_tropo=False pins the ZTD state at its a-priori value
        # (RTKLIB tropopt=OFF): with few satellites the 1/sin(el) mapping
        # is nearly collinear with height, and thousands of correlated
        # phase epochs can drag the (height, ZTD) pair meters along the
        # degenerate direction while the fit stays perfect
        self.estimate_tropo = estimate_tropo
        self.p = np.diag([100.0 ** 2] * 3
                         + [1e9, 0.25 if estimate_tropo else 0.0])
        self.epoch = 0
        self.n_slips = 0

    def _ensure_sat(self, key) -> int:
        if key not in self.sat_index:
            i = len(self.x)
            self.sat_index[key] = i
            self.x = np.append(self.x, 0.0)
            p = np.zeros((i + 1, i + 1))
            p[:i, :i] = self.p
            p[i, i] = 1e6                 # new float ambiguity
            self.p = p
        return self.sat_index[key]

    def reset_ambiguity(self, key: tuple) -> None:
        """Cycle slip on (system, prn): reinitialize its ambiguity state
        (reference udbias_ppp on detected slip)."""
        if key not in self.sat_index:
            return
        i = self.sat_index[key]
        self.x[i] = 0.0
        self.p[i, :] = 0.0
        self.p[:, i] = 0.0
        self.p[i, i] = 1e6
        self.n_slips += 1

    def update(self, obs: list[PppObs], dt_s: float = 1.0,
               slips: set | None = None) -> PppSolution:
        usable = [o for o in obs
                  if _eph_lookup(self.ephemerides, o) is not None]
        if len(usable) < 4:
            return PppSolution(valid=False, n_sats=len(usable))
        self.epoch += 1

        # time update: position static or random walk, clock white, ZTD RW
        if self.mode == "kinematic":
            self.p[:3, :3] += np.eye(3) * (self.q_pos * max(dt_s, 0.0))
        self.p[3, :] = 0.0
        self.p[:, 3] = 0.0
        self.p[3, 3] = self.q_clk
        if self.estimate_tropo:
            self.p[4, 4] += self.q_ztd

        if slips:
            for key in slips:
                self.reset_ambiguity(key)
        for o in usable:
            self._ensure_sat((o.system, o.prn))

        n = len(self.x)
        pos = self.x[:3]
        lat, lon, hgt = geodesy.ecef_to_geodetic(pos)

        for o in usable:
            eph = _eph_lookup(self.ephemerides, o)
            dts = eph.clock_offset(o.t_tx_sv)
            sp, _ = eph.position_velocity(o.t_tx_sv - dts)
            tau = np.linalg.norm(sp - pos) / C.SPEED_OF_LIGHT_M_S
            sp = _rotate_sat(sp, tau)
            rho = np.linalg.norm(sp - pos)
            los = (sp - pos) / rho
            az, el = geodesy.az_el(pos, sp)
            m = tropo_mapping(el)
            i_amb = self.sat_index[(o.system, o.prn)]

            for kind, z, sig in (("pr", o.pr_if_m, self.sigma_pr),
                                 ("ph", o.phase_if_m, self.sigma_ph)):
                h = np.zeros(n)
                h[:3] = -los
                h[3] = 1.0
                h[4] = m
                # linearize around the epoch-start position `pos` and apply
                # the within-epoch state increment through h (sequential
                # scalar updates must not re-evaluate the nonlinear range
                # at the moving state — that double-counts corrections)
                pred = (rho + h[:3] @ (self.x[:3] - pos)
                        + C.SPEED_OF_LIGHT_M_S * (-dts)
                        + self.x[3] + m * self.x[4])
                if kind == "ph":
                    h[i_amb] = 1.0
                    pred += self.x[i_amb]
                y = z - pred
                # scalar sequential measurement update
                ph_vec = self.p @ h
                s = float(h @ ph_vec) + sig ** 2
                k = ph_vec / s
                self.x = self.x + k * y
                self.p = self.p - np.outer(k, ph_vec)
        self.p = 0.5 * (self.p + self.p.T)

        return PppSolution(
            valid=True, pos_ecef=self.x[:3].copy(),
            clock_bias_m=float(self.x[3]), ztd_m=float(self.x[4]),
            n_sats=len(usable),
            sigma_pos_m=float(np.sqrt(np.trace(self.p[:3, :3]))))
