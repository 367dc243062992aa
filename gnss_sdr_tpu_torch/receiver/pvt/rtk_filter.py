"""Kinematic RTK: epoch-to-epoch EKF with persistent ambiguity states.

The port's copy of gnss_sdr_tpu/receiver/pvt/rtk_filter.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: the filtered relative-positioning core of
``src/algorithms/libs/rtklib/rtklib_rtkpos.cc`` (``relpos`` +  ``udstate``,
:2787 and the state-update helpers above it): a Kalman filter whose state is
the rover position plus one single-difference (rover-minus-base) carrier
ambiguity per tracked satellite, updated every epoch with double-difference
code and phase measurements, with

  - positioning modes ``static`` (position states constant) and
    ``kinematic`` (position reinitialized with large variance each epoch —
    RTKLIB's VAR_POS reset when dynamics are off),
  - cycle-slip detection (Doppler phase prediction + externally supplied
    loss-of-lock indicators, RTKLIB ``detslp_ll``/``detslp_dop``) that
    reinitializes the affected ambiguity state,
  - per-epoch integer resolution of the double-difference ambiguities with
    LAMBDA + ratio test (``resamb_LAMBDA``), conditioning the position on
    the fixed integers, and optional fix-and-hold (``holdamb``).

Single-difference ambiguity states (not DD) keep the filter independent of
the reference-satellite choice, exactly as RTKLIB stores per-satellite bias
states and differences them in the measurement model. Host numpy float64 —
this is control-plane math at the PVT rate, not the device data plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.receiver.pvt import lambda_ilsq
from gnss_sdr_tpu_torch.receiver.pvt.rtk import RtkObs, RtkSolution, _sat_pos
from gnss_sdr_tpu_torch.receiver.pvt.solver import _eph_lookup


@dataclasses.dataclass
class RtkFilterConfig:
    mode: str = "kinematic"            # "kinematic" | "static"
    sigma_pr_m: float = 0.5            # zenith code noise (1-sigma)
    sigma_cp_m: float = 0.005          # zenith phase noise (meters)
    var_pos_kinematic: float = 30.0 ** 2   # per-epoch position reset variance
    var_amb_init: float = 100.0 ** 2   # new/slipped ambiguity variance (cyc^2)
    ratio_threshold: float = 3.0
    slip_doppler_cycles: float = 1.0   # |dphi - doppler*dt| slip threshold
    # fallback when no base Doppler is available (MSM4/legacy base): SD
    # code-minus-carrier jump threshold, coarse because code noise enters
    slip_code_carrier_cycles: float = 15.0
    fix_and_hold: bool = False         # RTKLIB "fix and hold" mode
    hold_var_cyc2: float = 0.1 ** 2    # pseudo-measurement variance for hold
    min_common: int = 5


class RtkFilter:
    """Filtered double-difference RTK against a fixed base station."""

    def __init__(self, base_ecef: np.ndarray, ephemerides: dict,
                 config: RtkFilterConfig | None = None,
                 x0_ecef: np.ndarray | None = None):
        self.cfg = config or RtkFilterConfig()
        self.base_ecef = np.asarray(base_ecef, np.float64)
        self.ephemerides = ephemerides
        self.x = np.array(x0_ecef if x0_ecef is not None else base_ecef,
                          np.float64).copy()          # pos(3) + ambiguities
        self.p = np.eye(3) * 100.0 ** 2
        self.sat_index: dict[tuple, int] = {}          # (sys, prn) -> state i
        # key -> (tow, phase_sd, dop_sd | None, code_sd)
        self._prev: dict[tuple, tuple] = {}
        self.epoch = 0
        self.n_slips = 0

    # ------------------------------------------------------------ states
    def _add_state(self, init: float, var: float) -> int:
        i = len(self.x)
        self.x = np.append(self.x, init)
        p = np.zeros((i + 1, i + 1))
        p[:i, :i] = self.p
        p[i, i] = var
        self.p = p
        return i

    def _reset_state(self, i: int, init: float, var: float) -> None:
        self.x[i] = init
        self.p[i, :] = 0.0
        self.p[:, i] = 0.0
        self.p[i, i] = var

    def _drop_stale(self, live: set) -> None:
        """Remove ambiguity states for satellites no longer observed."""
        stale = [k for k in self.sat_index if k not in live]
        if not stale:
            return
        keep = [i for i in range(len(self.x))
                if i < 3 or i in {self.sat_index[k] for k in self.sat_index
                                  if k not in stale}]
        remap = {old: new for new, old in enumerate(keep)}
        self.x = self.x[keep]
        self.p = self.p[np.ix_(keep, keep)]
        for k in stale:
            del self.sat_index[k]
            self._prev.pop(k, None)
        self.sat_index = {k: remap[i] for k, i in self.sat_index.items()}

    # ------------------------------------------------------------ update
    def update(self, rover: list[RtkObs], base: list[RtkObs], tow: float,
               lli: set | None = None) -> RtkSolution:
        """One epoch. ``lli``: keys (system, prn) flagged lost-lock upstream
        (reference: the LLI bit in obsd_t, detslp_ll)."""
        cfg = self.cfg
        rov = {(o.system, o.prn): o for o in rover}
        bas = {(o.system, o.prn): o for o in base}
        common = [k for k in rov if k in bas
                  and _eph_lookup(self.ephemerides, rov[k]) is not None]
        if len(common) < cfg.min_common:
            return RtkSolution(valid=False, n_dd=max(0, len(common) - 1))
        self.epoch += 1
        self._drop_stale(set(common))

        lam = {k: C.SPEED_OF_LIGHT_M_S / rov[k].carrier_freq_hz
               for k in common}
        # single differences (rover - base)
        sd_pr = {k: rov[k].pseudorange_m - bas[k].pseudorange_m
                 for k in common}
        sd_cp = {k: rov[k].carrier_phase_cycles - bas[k].carrier_phase_cycles
                 for k in common}
        # single-difference Doppler: satellite motion appears in BOTH phases,
        # so slip prediction must difference the Dopplers too (a rover-only
        # prediction is off by the base's range rate — thousands of cyc/s)
        sd_dop = {k: rov[k].doppler_hz - bas[k].doppler_hz for k in common}

        # --- time update (udstate): position noise per mode
        if cfg.mode == "kinematic":
            self.p[:3, :] = 0.0
            self.p[:, :3] = 0.0
            self.p[:3, :3] = np.eye(3) * cfg.var_pos_kinematic

        # --- cycle-slip detection + ambiguity bookkeeping
        # Doppler prediction needs a measured phase rate on BOTH receivers;
        # base obs from MSM4/legacy messages carry none (has_doppler=False)
        # and would bias the prediction by the base's full range rate
        dop_ok = {k: (getattr(rov[k], "has_doppler", True)
                      and getattr(bas[k], "has_doppler", True))
                  for k in common}
        for k in common:
            slipped = lli is not None and k in lli
            prev = self._prev.get(k)
            if prev is not None and not slipped:
                t0, cp0, dop0, pr0 = prev
                dt = tow - t0
                if 0.0 < dt <= 10.0:
                    if dop_ok[k] and dop0 is not None:
                        # Doppler-predicted SD phase advance (detslp_dop):
                        # RINEX convention D = -d(rho)/dt / lambda and
                        # L ~ rho/lambda + N, so dL/dt = -D
                        pred = -0.5 * (sd_dop[k] + dop0) * dt
                        if (abs(sd_cp[k] - cp0 - pred)
                                > cfg.slip_doppler_cycles):
                            slipped = True
                    else:
                        # code-minus-carrier divergence fallback (rtklib
                        # detslp_gf role on single-frequency data): the SD
                        # geometry cancels between code and carrier, so a
                        # jump in (carrier - code) is a slip. Code noise
                        # forces a coarser threshold than the Doppler test.
                        div = ((sd_cp[k] - cp0)
                               - (sd_pr[k] - pr0) / lam[k])
                        if abs(div) > cfg.slip_code_carrier_cycles:
                            slipped = True
            if k not in self.sat_index:
                init = sd_cp[k] - sd_pr[k] / lam[k]
                self.sat_index[k] = self._add_state(init, cfg.var_amb_init)
            elif slipped:
                init = sd_cp[k] - sd_pr[k] / lam[k]
                self._reset_state(self.sat_index[k], init, cfg.var_amb_init)
                self.n_slips += 1
            self._prev[k] = (tow, sd_cp[k],
                             sd_dop[k] if dop_ok[k] else None, sd_pr[k])

        # --- geometry at the current state
        sat = {}
        sat_b = {}
        el = {}
        for k in common:
            o = rov[k]
            eph = _eph_lookup(self.ephemerides, o)
            sat[k] = _sat_pos(eph, o.t_tx_sv, self.x[:3])
            # base side at the base measurement instant (rover clock bias
            # otherwise leaks satellite motion into the baseline, rtk.py)
            b = bas[k]
            sat_b[k] = (_sat_pos(eph, b.t_tx_sv, self.base_ecef)
                        if b.t_tx_sv else sat[k])
            los = sat[k] - self.base_ecef
            el[k] = float((los / np.linalg.norm(los))
                          @ (self.base_ecef / np.linalg.norm(self.base_ecef)))
        # reference satellite per system: highest elevation proxy
        systems = sorted({k[0] for k in common})
        refs = {s: max((k for k in common if k[0] == s), key=lambda k: el[k])
                for s in systems}
        others = [k for k in common if k != refs[k[0]]]
        n_dd = len(others)
        if n_dd < 3:
            return RtkSolution(valid=False, n_dd=n_dd)

        # --- EKF measurement update with DD code + DD phase
        nx = len(self.x)
        pos = self.x[:3].copy()

        def geom(x3):
            rho_r = {k: np.linalg.norm(sat[k] - x3) for k in common}
            e_r = {k: (sat[k] - x3) / rho_r[k] for k in common}
            rho_b = {k: np.linalg.norm(sat_b[k] - self.base_ecef)
                     for k in common}
            return rho_r, e_r, rho_b

        rho_r, e_r, rho_b = geom(pos)
        h = np.zeros((2 * n_dd, nx))
        y = np.zeros(2 * n_dd)
        r_diag = np.zeros(2 * n_dd)
        for i, k in enumerate(others):
            ref = refs[k[0]]
            dd_rho = (rho_r[k] - rho_b[k]) - (rho_r[ref] - rho_b[ref])
            grad = -(e_r[k] - e_r[ref])
            # code DD (meters)
            dd_pr = sd_pr[k] - sd_pr[ref]
            h[i, :3] = grad
            y[i] = dd_pr - dd_rho
            # var(DD) = var(SD_k) + var(SD_ref) = 4 sigma^2 (each single
            # difference carries rover + base noise)
            r_diag[i] = 4.0 * cfg.sigma_pr_m ** 2
            # phase DD (meters), ambiguity part lam*(N_k - N_ref)
            ik, ir = self.sat_index[k], self.sat_index[ref]
            dd_cp = lam[k] * (sd_cp[k] - sd_cp[ref])
            j = n_dd + i
            h[j, :3] = grad
            h[j, ik] = lam[k]
            h[j, ir] = -lam[k]
            y[j] = dd_cp - dd_rho - lam[k] * (self.x[ik] - self.x[ir])
            r_diag[j] = 4.0 * cfg.sigma_cp_m ** 2
        # DD correlation through the shared reference satellite:
        # cov(DD_i, DD_j) = var(SD_ref) = 2 sigma^2
        r = np.diag(r_diag)
        for blk, sig in ((0, cfg.sigma_pr_m), (n_dd, cfg.sigma_cp_m)):
            for i, ki in enumerate(others):
                for j2, kj in enumerate(others):
                    if i != j2 and ki[0] == kj[0]:
                        r[blk + i, blk + j2] = 2.0 * sig ** 2

        ph = self.p @ h.T
        s = h @ ph + r
        try:
            k_gain = ph @ np.linalg.inv(s)
        except np.linalg.LinAlgError:
            return RtkSolution(valid=False, n_dd=n_dd)
        self.x = self.x + k_gain @ y
        self.p = (np.eye(nx) - k_gain @ h) @ self.p
        self.p = 0.5 * (self.p + self.p.T)

        float_pos = self.x[:3].copy()
        sol = RtkSolution(valid=True, fixed=False, n_dd=n_dd,
                          baseline_m=float_pos - self.base_ecef,
                          rover_ecef=float_pos,
                          float_baseline_m=float_pos - self.base_ecef)

        # --- integer resolution on the DD-projected ambiguities
        d = np.zeros((n_dd, nx))
        for i, k in enumerate(others):
            d[i, self.sat_index[k]] = 1.0
            d[i, self.sat_index[refs[k[0]]]] = -1.0
        a_float = d @ self.x
        q_a = d @ self.p @ d.T
        q_xa = self.p[:3, :] @ d.T
        try:
            cands, norms = lambda_ilsq.lambda_ils(a_float, q_a, n_cands=2)
        except np.linalg.LinAlgError:
            return sol
        if len(cands) == 0:
            return sol
        sol.ratio = (float(norms[1] / max(norms[0], 1e-12))
                     if len(norms) > 1 else 0.0)
        if not lambda_ilsq.ratio_test(norms, cfg.ratio_threshold):
            return sol
        a_fix = cands[0]
        # condition the position on the fixed integers:
        # x_f = x - Q_xa Q_a^-1 (a_float - a_fix)
        try:
            corr = q_xa @ np.linalg.solve(q_a, a_float - a_fix)
        except np.linalg.LinAlgError:
            return sol
        fixed_pos = float_pos - corr
        sol.fixed = True
        sol.rover_ecef = fixed_pos
        sol.baseline_m = fixed_pos - self.base_ecef
        sol.ambiguities = a_fix

        if cfg.fix_and_hold:
            # holdamb: pseudo-measurements pinning DD ambiguities at the
            # fixed integers tighten all correlated states
            v = a_fix - d @ self.x
            s2 = d @ self.p @ d.T + np.eye(n_dd) * cfg.hold_var_cyc2
            try:
                kg = self.p @ d.T @ np.linalg.inv(s2)
            except np.linalg.LinAlgError:
                return sol
            self.x = self.x + kg @ v
            self.p = (np.eye(nx) - kg @ d) @ self.p
            self.p = 0.5 * (self.p + self.p.T)
        return sol
