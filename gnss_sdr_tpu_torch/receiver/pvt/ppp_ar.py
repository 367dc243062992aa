"""PPP with integer ambiguity resolution (PPP-AR).

The port's copy of gnss_sdr_tpu/receiver/pvt/ppp_ar.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: the ambiguity-resolution branch of
``src/algorithms/libs/rtklib/rtklib_ppp.cc`` (``pppamb``: average the
Melbourne-Wübbena combination to fix between-satellite wide-lane integers
``fix_amb_WL``, then resolve the narrow-lane / L1 integers from the
iono-free float ambiguities with LAMBDA ``fix_amb_ILS`` and constrain the
filter states on the fixed values).

Observation model (dual frequency, per satellite):
  MW       = (f1*L1 - f2*L2)/(f1 - f2) - (f1*P1 + f2*P2)/(f1 + f2)
           = lam_wl * N_wl + bias            (geometry/iono free)
  B_IF     = iono-free phase ambiguity state of the float filter [m]
           = (c/(f1+f2)) * N1 + (c*f2/(f1^2-f2^2)) * N_wl
Receiver/satellite biases cancel in between-satellite single differences,
so the SD MW average yields integer N_wl (after convergence) and the SD
B_IF yields N1 through LAMBDA; the fixed SD values then tighten the filter
via pseudo-measurements exactly like RTK fix-and-hold. Host numpy float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.receiver.pvt import lambda_ilsq
from gnss_sdr_tpu_torch.receiver.pvt.ppp import PppFilter, PppObs, PppSolution


@dataclasses.dataclass
class PppArObs(PppObs):
    """Dual-frequency raw observables for the MW combination (in addition
    to the iono-free combinations consumed by the float filter)."""

    p1_m: float = 0.0
    p2_m: float = 0.0
    l1_cycles: float = 0.0
    l2_cycles: float = 0.0
    f1_hz: float = 1_575_420_000.0
    f2_hz: float = 1_227_600_000.0


class PppArFilter(PppFilter):
    """Float PPP + wide-lane/narrow-lane integer resolution."""

    def __init__(self, *args, wl_sigma_max: float = 0.25,
                 ratio_threshold: float = 3.0,
                 hold_var_m2: float = 0.03 ** 2,
                 min_fix_epoch: int = 20,
                 max_pos_sigma_m: float = 0.35,
                 code_bias_m: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.wl_sigma_max = wl_sigma_max
        self.ratio_threshold = ratio_threshold
        # per-satellite SYSTEMATIC pseudorange bias the filter's white-noise
        # model cannot see (receiver DLL/ZOH biases, uncalibrated DCBs).
        # Such biases push the float B_IF states off by bias-level amounts
        # that never average down, so the narrow-lane search around the
        # float finds a wrong-but-self-consistent integer set at high ratio
        # confidence (round-5 dual-band diagnosis: correct wide lanes,
        # narrow lanes off by 2-7 cycles, held solution parked 0.3-1.3 m
        # out while the float sat at 4 cm). Adding this term to the search
        # covariance makes the ratio test honestly DECLINE fixes the data
        # cannot support. 0 = trust the filter covariance (calibrated
        # receivers / simulation-grade code).
        self.code_bias_m = float(code_bias_m)
        # bootstrapped-success-rate AR gate (lambda_ilsq.bootstrap_
        # success_rate): the ratio test alone degenerates to a rounding-
        # distance ratio once the covariance carries a large common term,
        # so acceptance ALSO requires the decorrelated covariance to
        # support integer estimation at this success probability
        self.min_success_rate = 0.9
        self.last_success_rate = 0.0
        # soft hold (RTKLIB holdamb uses ~0.1 cyc): a premature wrong fix
        # must remain escapable as the float information accumulates
        self.hold_var_m2 = hold_var_m2
        # AR gates (rtklib pppamb applies elevation/epoch gates similarly):
        # no integer search until the float filter has seen min_fix_epoch
        # epochs and its formal position sigma is below max_pos_sigma_m
        self.min_fix_epoch = min_fix_epoch
        self.max_pos_sigma_m = max_pos_sigma_m
        # per-satellite MW running stats: key -> [n, mean, m2]
        self._mw: dict[tuple, list] = {}
        # bounded per-satellite MW history for the lag-1 autocorrelation
        # estimate (see _mw_sigma)
        self._mw_hist: dict[tuple, list] = {}
        self.n_fixed_epochs = 0
        self.last_ratio = 0.0
        self.best_ratio = 0.0      # max ratio seen (last_ratio fluctuates)
        self.fixed_wl: dict[tuple, int] = {}
        # fix-and-hold engages only after the SAME integer set has won the
        # ratio test on hold_after consecutive epochs (RTKLIB's
        # min-fix-to-hold): holding the first ratio-passing fix can lock in
        # wrong narrow-lane integers chosen off a not-yet-converged float
        self.hold_after = 5
        self._last_fix: tuple | None = None
        self._fix_streak = 0
        # wrong-fix recovery: a held integer set that stops winning the
        # ratio test for hold_release_after consecutive attempts is
        # RELEASED — ambiguity states reset and the position/clock
        # variances re-inflated so the float can re-converge and re-fix
        # (a hold taken off a not-yet-converged float would otherwise
        # freeze the solution at the fix-time error forever)
        self.hold_release_after = 10
        self._held = False
        self._hold_miss = 0

    # ------------------------------------------------------------- MW
    def _update_mw(self, obs: list[PppArObs], slips: set | None) -> None:
        for o in obs:
            key = (o.system, o.prn)
            if slips and key in slips:
                self._mw.pop(key, None)
                self._mw_hist.pop(key, None)
                self.fixed_wl.pop(key, None)
            f1, f2 = o.f1_hz, o.f2_hz
            lam1 = C.SPEED_OF_LIGHT_M_S / f1
            lam2 = C.SPEED_OF_LIGHT_M_S / f2
            mw = ((f1 * o.l1_cycles * lam1 - f2 * o.l2_cycles * lam2)
                  / (f1 - f2)
                  - (f1 * o.p1_m + f2 * o.p2_m) / (f1 + f2))
            lam_wl = C.SPEED_OF_LIGHT_M_S / (f1 - f2)
            mw_cyc = mw / lam_wl
            st = self._mw.setdefault(key, [0, 0.0, 0.0])
            st[0] += 1
            delta = mw_cyc - st[1]
            st[1] += delta / st[0]
            st[2] += delta * (mw_cyc - st[1])
            h = self._mw_hist.setdefault(key, [])
            h.append(mw_cyc)
            if len(h) > 4096:
                del h[: len(h) - 4096]

    def _mw_sigma(self, key) -> float:
        """Sigma of the MW running mean, inflated by the effective-sample-
        size factor sqrt((1+rho)/(1-rho)) from the lag-1 autocorrelation.

        The MW combination is dominated by code noise, whose DLL-loop
        correlation time (~1/(2*B_DLL), 0.1-0.25 s for 2-4 Hz loops) spans
        several observation epochs: the plain sigma/sqrt(n) estimate then
        understates the mean's error by up to ~sqrt(f_obs * tau) and the
        wide-lane rounding gates open on immature averages (the failure
        mode behind the round-4 dual-band wrong-hold regression)."""
        st = self._mw.get(key)
        if st is None or st[0] < 2:
            return np.inf
        sig = float(np.sqrt(st[2] / (st[0] - 1) / st[0]))   # sigma of mean
        h = self._mw_hist.get(key)
        if h is not None and len(h) >= 8:
            x = np.asarray(h) - np.mean(h)
            var = float(np.mean(x * x))
            if var > 0.0:
                rho = float(np.mean(x[1:] * x[:-1]) / var)
                rho = min(max(rho, 0.0), 0.95)
                sig *= float(np.sqrt((1.0 + rho) / (1.0 - rho)))
        return sig

    # ------------------------------------------------------------- update
    def update(self, obs: list[PppArObs], dt_s: float = 1.0,
               slips: set | None = None) -> PppSolution:
        self._update_mw(obs, slips)
        sol = super().update(obs, dt_s=dt_s, slips=slips)
        if not sol.valid:
            return sol
        self._try_fix(obs, sol)
        return sol

    def _release_hold(self) -> None:
        """Undo a (presumed wrong) fix-and-hold: reset every ambiguity
        state and re-inflate the position/clock variances contaminated by
        the held constraints. The float filter re-converges from the
        phase/code stream and AR gets a fresh attempt."""
        for key in list(self.sat_index):
            self.reset_ambiguity(key)
        for i in range(4):               # position + receiver clock
            self.p[i, :] = 0.0
            self.p[:, i] = 0.0
            self.p[i, i] = 1.0 ** 2 if i < 3 else 100.0 ** 2
        self._held = False
        self._hold_miss = 0
        self._fix_streak = 0
        self._last_fix = None
        self.fixed_wl = {}

    def _try_fix(self, obs: list[PppArObs], sol: PppSolution) -> None:
        if self.epoch < self.min_fix_epoch:
            return
        if np.sqrt(np.trace(self.p[:3, :3])) > self.max_pos_sigma_m:
            return
        # candidate satellites: MW average converged, state present
        by_key = {(o.system, o.prn): o for o in obs}
        cands = [k for k in by_key
                 if k in self.sat_index and self._mw_sigma(k) < self.wl_sigma_max]
        if len(cands) < 4:
            return
        ref = max(cands, key=lambda k: self._mw[k][0])
        others = sorted(k for k in cands if k != ref)
        if not others:
            return

        # 1) fix SD wide-lane integers from the MW averages. A satellite
        # whose SD wide lane is not confidently integer is DROPPED from
        # this epoch's fix (partial AR, rtklib's satellite-exclusion
        # behavior) rather than aborting the whole attempt — one noisy
        # MW average must not veto the resolvable subset.
        n_wl = {}
        for k in others:
            sd = self._mw[k][1] - self._mw[ref][1]
            n_int = int(np.round(sd))
            if abs(sd - n_int) > 3.0 * max(
                    self._mw_sigma(k), self._mw_sigma(ref), 0.05):
                continue                   # not confidently integer yet
            n_wl[k] = n_int
        others = [k for k in others if k in n_wl]
        if len(others) < 3:                # need >= 3 SD + ref
            return
        self.fixed_wl = {k: n_wl[k] for k in others}

        # 2) narrow-lane: SD B_IF - wl term = (c/(f1+f2)) * N1_sd
        o0 = by_key[others[0]]
        f1, f2 = o0.f1_hz, o0.f2_hz
        c = C.SPEED_OF_LIGHT_M_S
        lam_nl = c / (f1 + f2)
        wl_coef = c * f2 / (f1 * f1 - f2 * f2)

        n = len(others)
        d = np.zeros((n, len(self.x)))
        for i, k in enumerate(others):
            d[i, self.sat_index[k]] = 1.0
            d[i, self.sat_index[ref]] = -1.0
        b_sd = d @ self.x                                   # SD B_IF [m]
        q_b = d @ self.p @ d.T
        a_float = np.array([(b_sd[i] - wl_coef * n_wl[k]) / lam_nl
                            for i, k in enumerate(others)])
        q_a = q_b / lam_nl ** 2
        if self.code_bias_m > 0.0:
            # single-differenced systematic bias: two independent
            # per-satellite biases -> 2 * sigma_bias^2 on the diagonal
            q_a = q_a + np.eye(n) * (2.0 * (self.code_bias_m / lam_nl) ** 2)
        self.last_success_rate = lambda_ilsq.bootstrap_success_rate(q_a)
        if self.last_success_rate < self.min_success_rate:
            # the covariance says integer estimation cannot succeed at an
            # acceptable rate — declining is the honest outcome (the ratio
            # test would still "pass" by rounding luck, see round-5 notes)
            self._fix_streak = 0
            self._last_fix = None
            if self._held:
                self._hold_miss += 1
                if self._hold_miss >= self.hold_release_after:
                    self._release_hold()
            return
        try:
            cands2, norms = lambda_ilsq.lambda_ils(a_float, q_a, n_cands=2)
        except np.linalg.LinAlgError:
            return
        if len(cands2) == 0:
            return
        self.last_ratio = (float(norms[1] / max(norms[0], 1e-12))
                           if len(norms) > 1 else 0.0)
        self.best_ratio = max(self.best_ratio, self.last_ratio)
        if not lambda_ilsq.ratio_test(norms, self.ratio_threshold):
            self._fix_streak = 0
            self._last_fix = None
            if self._held:
                self._hold_miss += 1
                if self._hold_miss >= self.hold_release_after:
                    self._release_hold()
            return
        n1 = cands2[0]

        # 3) constrain with pseudo-measurements of the fixed SD B_IF — on a
        # COPY first: the fixed solution is always reported, but the filter
        # state is only overwritten (fix-and-hold) once the same integer
        # set has survived hold_after consecutive ratio tests
        b_fix = np.array([lam_nl * n1[i] + wl_coef * n_wl[k]
                          for i, k in enumerate(others)])
        v = b_fix - d @ self.x
        s = d @ self.p @ d.T + np.eye(n) * self.hold_var_m2
        try:
            kg = self.p @ d.T @ np.linalg.inv(s)
        except np.linalg.LinAlgError:
            return
        x_fix = self.x + kg @ v
        p_fix = (np.eye(len(self.x)) - kg @ d) @ self.p
        p_fix = 0.5 * (p_fix + p_fix.T)
        fix_key = (ref, tuple(n_wl[k] for k in others),
                   tuple(int(round(a)) for a in n1))
        if fix_key == self._last_fix:
            self._fix_streak += 1
        else:
            self._last_fix = fix_key
            self._fix_streak = 1
        if self._fix_streak >= self.hold_after:
            self.x, self.p = x_fix, p_fix
            self._held = True
            self._hold_miss = 0
        self.n_fixed_epochs += 1
        sol.pos_ecef = x_fix[:3].copy()
        sol.clock_bias_m = float(x_fix[3])
        sol.ztd_m = float(x_fix[4])
