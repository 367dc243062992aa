"""Double-difference RTK positioning (single-epoch float + LAMBDA fix).

The port's copy of gnss_sdr_tpu/receiver/pvt/rtk.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: the kinematic relative-positioning core of
``src/algorithms/libs/rtklib/rtklib_rtkpos.cc`` (``relpos()``): form
between-receiver, between-satellite double differences of pseudorange and
carrier phase against a base station at a known position, estimate the
float baseline + DD ambiguities by weighted least squares, resolve the
ambiguities with LAMBDA (``lambda_ilsq.py``) and validate with the ratio
test, then compute the fixed baseline.

Single-epoch (instantaneous) mode: every epoch is solved independently —
no filter state — which is the hardest case for ambiguity resolution and
the simplest to make deterministic/testable. Host numpy float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.receiver.pvt import lambda_ilsq
from gnss_sdr_tpu_torch.receiver.pvt.solver import _eph_lookup, _rotate_sat


@dataclasses.dataclass
class RtkObs:
    """One receiver's observation of one satellite at the common epoch."""

    prn: int
    pseudorange_m: float
    carrier_phase_cycles: float
    carrier_freq_hz: float = 1_575_420_000.0
    cn0_dbhz: float = 45.0
    system: str = "G"
    t_tx_sv: float = 0.0
    doppler_hz: float = 0.0     # used by RtkFilter slip detection
    # False when the observation source had no phase-rate field (base obs
    # from MSM4 / legacy 1002/1004/1012); RtkFilter then uses the
    # code-minus-carrier divergence slip test instead of Doppler prediction
    has_doppler: bool = True


@dataclasses.dataclass
class RtkSolution:
    valid: bool
    fixed: bool = False
    baseline_m: np.ndarray = None       # rover - base, ECEF
    rover_ecef: np.ndarray = None
    ratio: float = 0.0
    n_dd: int = 0
    ambiguities: np.ndarray = None      # fixed DD ambiguities (cycles)
    float_baseline_m: np.ndarray = None


def _sat_pos(eph, t_tx_sv: float, station_ecef: np.ndarray) -> np.ndarray:
    """Satellite position at t_tx, Sagnac-rotated by the GEOMETRIC light
    time to ``station_ecef`` (a km-level station error costs only ~mm of
    rotation). The raw pseudorange is NOT a safe light-time proxy here: it
    carries the receiver clock bias, and with per-side satellite positions
    a clock-bias-scaled rotation no longer cancels in the differences."""
    dt_sv = eph.clock_offset(t_tx_sv)
    p, _ = eph.position_velocity(t_tx_sv - dt_sv)
    tau = np.linalg.norm(p - station_ecef) / C.SPEED_OF_LIGHT_M_S
    return _rotate_sat(p, tau)


def solve_rtk(rover: list[RtkObs], base: list[RtkObs],
              base_ecef: np.ndarray, ephemerides: dict,
              rover_apriori: np.ndarray | None = None,
              sigma_pr_m: float = 0.5, sigma_cp_cycles: float = 0.01,
              ratio_threshold: float = 3.0) -> RtkSolution:
    """Single-epoch double-difference solution.

    Args:
      rover/base: per-satellite observations at the same receiver epoch
        (common satellites are matched by (system, prn); same signal).
      base_ecef: known base-station ECEF position [3].
      ephemerides: dict keyed (system, prn) (bare prn accepted for GPS).
      rover_apriori: linearization point (default: base position).

    Returns RtkSolution; ``fixed`` requires the LAMBDA ratio test to pass.
    """
    base_ecef = np.asarray(base_ecef, np.float64)
    rov = {(o.system, o.prn): o for o in rover}
    bas = {(o.system, o.prn): o for o in base}
    common = [k for k in rov if k in bas
              and _eph_lookup(ephemerides, rov[k]) is not None]
    if len(common) < 5:
        return RtkSolution(valid=False, n_dd=max(0, len(common) - 1))

    x0 = np.asarray(rover_apriori if rover_apriori is not None
                    else base_ecef, np.float64)

    # satellite positions per SIDE: the rover tow tag runs on the rover
    # clock, so the base measured the satellite at a slightly different
    # instant (satellites move ~4 km/s; a 20 ms rover clock bias otherwise
    # leaks ~10 m into the baseline — rtklib satposs runs per obs set)
    sat = {}
    sat_b = {}
    for k in common:
        o = rov[k]
        eph = _eph_lookup(ephemerides, o)
        sat[k] = _sat_pos(eph, o.t_tx_sv, x0)
        b = bas[k]
        sat_b[k] = (_sat_pos(eph, b.t_tx_sv, base_ecef)
                    if b.t_tx_sv else sat[k])

    # pick the reference satellite: highest elevation proxy = max |unit z|
    # relative to the base; RTKLIB uses max elevation per system
    def el_proxy(k):
        los = sat[k] - base_ecef
        return (los / np.linalg.norm(los)) @ (base_ecef
                                              / np.linalg.norm(base_ecef))
    ref = max(common, key=el_proxy)
    others = [k for k in common if k != ref]
    n = len(others)

    lam = {k: C.SPEED_OF_LIGHT_M_S / rov[k].carrier_freq_hz for k in common}

    def sd(obs_map, k, attr):
        return getattr(obs_map[k], attr)

    # DD measurement covariance: double differences sharing the reference
    # satellite are correlated — R = 2 sigma^2 (I + 1 1^T) per type, whose
    # inverse is (1/(2 sigma^2)) (I - 1 1^T / (n+1)) (RTKLIB propagates the
    # full DD covariance the same way)
    def _w_block(sigma):
        return (np.eye(n) - np.ones((n, n)) / (n + 1)) / (2.0 * sigma ** 2)

    w_full = np.zeros((2 * n, 2 * n))
    w_full[:n, :n] = _w_block(sigma_pr_m)
    lam0 = lam[others[0]] if others else 1.0
    w_full[n:, n:] = _w_block(sigma_cp_cycles * lam0)

    # iterate the float solution (geometry relinearization)
    x = x0.copy()
    amb_float = np.zeros(n)
    for _ in range(6):
        e_rov = {k: (sat[k] - x) / np.linalg.norm(sat[k] - x)
                 for k in common}
        rho_rov = {k: np.linalg.norm(sat[k] - x) for k in common}
        rho_bas = {k: np.linalg.norm(sat_b[k] - base_ecef) for k in common}

        # DD measurement residuals and geometry
        h = np.zeros((2 * n, 3 + n))
        y = np.zeros(2 * n)
        for i, k in enumerate(others):
            # predicted DD range from current x
            dd_rho = (rho_rov[k] - rho_bas[k]) - (rho_rov[ref] - rho_bas[ref])
            # pseudorange DD
            dd_pr = ((sd(rov, k, "pseudorange_m") - sd(bas, k, "pseudorange_m"))
                     - (sd(rov, ref, "pseudorange_m")
                        - sd(bas, ref, "pseudorange_m")))
            # carrier-phase DD in meters (with per-pair wavelength; assumes
            # same signal family so lam[k] == lam[ref])
            dd_cp = lam[k] * (
                (sd(rov, k, "carrier_phase_cycles")
                 - sd(bas, k, "carrier_phase_cycles"))
                - (sd(rov, ref, "carrier_phase_cycles")
                   - sd(bas, ref, "carrier_phase_cycles")))
            grad = -(e_rov[k] - e_rov[ref])
            h[i, :3] = grad
            y[i] = dd_pr - dd_rho
            h[n + i, :3] = grad
            h[n + i, 3 + i] = lam[k]
            y[n + i] = dd_cp - dd_rho - lam[k] * amb_float[i]
        hw = w_full @ h
        try:
            q = np.linalg.inv(h.T @ hw)
        except np.linalg.LinAlgError:
            return RtkSolution(valid=False, n_dd=n)
        dx = q @ (hw.T @ y)
        x += dx[:3]
        amb_float += dx[3:]
        if np.linalg.norm(dx[:3]) < 1e-4:
            break

    float_baseline = x - base_ecef
    q_amb = q[3:, 3:]

    sol = RtkSolution(valid=True, fixed=False, n_dd=n,
                      baseline_m=float_baseline.copy(),
                      rover_ecef=x.copy(),
                      float_baseline_m=float_baseline.copy())
    try:
        cands, norms = lambda_ilsq.lambda_ils(amb_float, q_amb, n_cands=2)
    except np.linalg.LinAlgError:
        return sol
    if len(cands) == 0:
        return sol
    sol.ratio = float(norms[1] / max(norms[0], 1e-12)) if len(norms) > 1 else 0.0
    if not lambda_ilsq.ratio_test(norms, ratio_threshold):
        return sol

    a_fix = cands[0]
    # fixed solution: re-solve the baseline with ambiguities held fixed
    x = sol.rover_ecef.copy()
    for _ in range(4):
        e_rov = {k: (sat[k] - x) / np.linalg.norm(sat[k] - x) for k in common}
        rho_rov = {k: np.linalg.norm(sat[k] - x) for k in common}
        rho_bas = {k: np.linalg.norm(sat_b[k] - base_ecef) for k in common}
        h = np.zeros((n, 3))
        y = np.zeros(n)
        for i, k in enumerate(others):
            dd_rho = (rho_rov[k] - rho_bas[k]) - (rho_rov[ref] - rho_bas[ref])
            dd_cp = lam[k] * (
                (sd(rov, k, "carrier_phase_cycles")
                 - sd(bas, k, "carrier_phase_cycles"))
                - (sd(rov, ref, "carrier_phase_cycles")
                   - sd(bas, ref, "carrier_phase_cycles")))
            h[i] = -(e_rov[k] - e_rov[ref])
            y[i] = dd_cp - lam[k] * a_fix[i] - dd_rho
        dx = np.linalg.lstsq(h, y, rcond=None)[0]
        x += dx
        if np.linalg.norm(dx) < 1e-6:
            break

    sol.fixed = True
    sol.rover_ecef = x
    sol.baseline_m = x - base_ecef
    sol.ambiguities = a_fix
    return sol


def solve_dgps(rover: list[RtkObs], base: list[RtkObs],
               base_ecef: np.ndarray, ephemerides: dict,
               rover_apriori: np.ndarray | None = None,
               sigma_pr_m: float = 0.5) -> RtkSolution:
    """Code-differential (DGPS/DGNSS) single-epoch solution — double-
    differenced PSEUDORANGES only, no ambiguity states.

    Reference analog: ``rtklib_rtkpos.cc`` PMODE_DGPS (``relpos`` with
    phase disabled): satellite clock, broadcast-ephemeris orbit error and
    atmospheric delays cancel in the base/rover differences over short
    baselines, leaving meter-level code accuracy without any carrier
    bookkeeping. Needs >= 4 common satellites (3 DDs for 3 unknowns).
    """
    base_ecef = np.asarray(base_ecef, np.float64)
    rov = {(o.system, o.prn): o for o in rover}
    bas = {(o.system, o.prn): o for o in base}
    common = [k for k in rov if k in bas
              and _eph_lookup(ephemerides, rov[k]) is not None]
    if len(common) < 4:
        return RtkSolution(valid=False, n_dd=max(0, len(common) - 1))

    x0 = np.asarray(rover_apriori if rover_apriori is not None
                    else base_ecef, np.float64)
    sat, sat_b = {}, {}
    for k in common:
        o = rov[k]
        eph = _eph_lookup(ephemerides, o)
        sat[k] = _sat_pos(eph, o.t_tx_sv, x0)
        b = bas[k]
        sat_b[k] = (_sat_pos(eph, b.t_tx_sv, base_ecef)
                    if b.t_tx_sv else sat[k])

    def el_proxy(k):
        los = sat[k] - base_ecef
        return (los / np.linalg.norm(los)) @ (base_ecef
                                              / np.linalg.norm(base_ecef))
    ref = max(common, key=el_proxy)
    others = [k for k in common if k != ref]
    n = len(others)
    # DD covariance: R = 2 sigma^2 (I + 1 1^T) -> W below (see solve_rtk)
    w = (np.eye(n) - np.ones((n, n)) / (n + 1)) / (2.0 * sigma_pr_m ** 2)

    x = x0.copy()
    for _ in range(8):
        e_rov = {k: (sat[k] - x) / np.linalg.norm(sat[k] - x)
                 for k in common}
        rho_rov = {k: np.linalg.norm(sat[k] - x) for k in common}
        rho_bas = {k: np.linalg.norm(sat_b[k] - base_ecef) for k in common}
        h = np.zeros((n, 3))
        y = np.zeros(n)
        for i, k in enumerate(others):
            dd_rho = (rho_rov[k] - rho_bas[k]) - (rho_rov[ref] - rho_bas[ref])
            dd_pr = ((rov[k].pseudorange_m - bas[k].pseudorange_m)
                     - (rov[ref].pseudorange_m - bas[ref].pseudorange_m))
            h[i] = -(e_rov[k] - e_rov[ref])
            y[i] = dd_pr - dd_rho
        hw = w @ h
        try:
            q = np.linalg.inv(h.T @ hw)
        except np.linalg.LinAlgError:
            return RtkSolution(valid=False, n_dd=n)
        dx = q @ (hw.T @ y)
        x += dx
        if np.linalg.norm(dx) < 1e-4:
            break
    return RtkSolution(valid=True, fixed=False, n_dd=n,
                       baseline_m=(x - base_ecef).copy(),
                       rover_ecef=x.copy(),
                       float_baseline_m=(x - base_ecef).copy())
