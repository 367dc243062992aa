"""Single-point PVT solver: Bancroft initialization + iterated weighted LS.

The receiver's equivalent of the reference PVT core
(``Rtklib_Solver::get_PVT`` -> ``rtkpos`` -> ``pntpos``,
``src/algorithms/libs/rtklib/rtklib_pntpos.cc:161``): single-point position,
velocity and receiver clock from pseudoranges/Doppler, with SV clock,
relativistic, TGD, Klobuchar iono, Saastamoinen tropo and Earth-rotation
corrections. Host numpy float64 — PVT runs at ~Hz, precision matters more
than throughput here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.models.ephemeris import IonoParams
from gnss_sdr_tpu_torch.receiver.pvt import atmosphere, geodesy


@dataclasses.dataclass
class ObsInput:
    """One channel's measurement at a common receiver epoch."""

    prn: int
    pseudorange_m: float
    doppler_hz: float          # carrier Doppler (positive = approaching)
    carrier_freq_hz: float     # nominal carrier of the tracked signal
    t_tx_sv: float             # transmit time in SV clock (s of week)
    cn0_dbhz: float = 45.0
    system: str = "G"          # constellation: G(PS) E(Galileo) R(GLONASS) C(BeiDou)
    iono_free: bool = False    # True: skip the ionosphere model (dual-freq)
    # small-magnitude timing (simulation oracle only): t_offset_s =
    # tau - dt_sv, so t_tx_sv == t_reception - t_offset_s EXACTLY. t_tx_sv
    # itself sits at ~3.5e5 s where one float64 ulp is 5.8e-11 s = 1.7 cm*c;
    # trajectory FITS must use this field to stay below the mm level
    # (RTKLIB splits gtime_t into int + fractional seconds for the same
    # reason). 0.0 when not populated.
    t_offset_s: float = 0.0


def combine_iono_free(obs: list["ObsInput"]) -> list["ObsInput"]:
    """Merge dual-frequency observations of the same satellite into the
    first-order iono-free pseudorange combination
    PR_IF = (f1^2 PR1 - f2^2 PR2) / (f1^2 - f2^2)  (RTKLIB ionocorr/IFLC
    role, rtklib_pntpos.cc). Single-frequency satellites pass through."""
    by_sat: dict[tuple, list[ObsInput]] = {}
    for o in obs:
        by_sat.setdefault((o.system, o.prn), []).append(o)
    out = []
    for sat, group in by_sat.items():
        if len(group) < 2:
            out.extend(group)
            continue
        group = sorted(group, key=lambda o: -o.carrier_freq_hz)
        o1, o2 = group[0], group[1]
        f1sq, f2sq = o1.carrier_freq_hz ** 2, o2.carrier_freq_hz ** 2
        pr = (f1sq * o1.pseudorange_m - f2sq * o2.pseudorange_m) / (f1sq - f2sq)
        out.append(dataclasses.replace(o1, pseudorange_m=pr, iono_free=True))
    return out


@dataclasses.dataclass
class PvtSolution:
    valid: bool
    pos_ecef: np.ndarray = None
    vel_ecef: np.ndarray = None
    clock_bias_s: float = 0.0
    clock_drift_s_s: float = 0.0
    # per-system receiver clock biases (s), keyed by constellation letter;
    # entry "G" (or the first system present) equals clock_bias_s. The
    # differences are the inter-system biases (reference: rtklib pntpos
    # estimates 3+NSYS states the same way).
    system_clock_s: dict = dataclasses.field(default_factory=dict)
    # RAIM: (system, prn) excluded by fault detection, None if none
    excluded_prn: tuple | None = None
    # which usable observations entered the final solution (elevation mask)
    used_mask: np.ndarray = None
    tow_s: float = 0.0
    week: int = 0
    n_sats: int = 0
    gdop: float = 0.0
    pdop: float = 0.0
    hdop: float = 0.0
    vdop: float = 0.0
    residuals_m: np.ndarray = None
    lat_rad: float = 0.0
    lon_rad: float = 0.0
    height_m: float = 0.0


def bancroft(sat_pos: np.ndarray, pr: np.ndarray) -> np.ndarray:
    """Closed-form initial position+clock (Bancroft 1985).

    sat_pos: [N,3] ECEF at transmit (rotated), pr: [N] corrected pseudoranges.
    Returns [x, y, z, c*dt].
    """
    n = len(pr)
    b = np.hstack([sat_pos, pr[:, None]])
    alpha = 0.5 * (np.sum(sat_pos ** 2, axis=1) - pr ** 2)
    m = np.diag([1.0, 1.0, 1.0, -1.0])

    def lorentz(a, bb):
        return a @ m @ bb

    binv = np.linalg.pinv(b)
    e = binv @ np.ones(n)
    f = binv @ alpha
    a2 = lorentz(e, e)
    a1 = 2.0 * (lorentz(e, f) - 1.0)
    a0 = lorentz(f, f)
    disc = a1 * a1 - 4.0 * a2 * a0
    if disc < 0:
        disc = 0.0
    best, best_res = None, np.inf
    for sgn in (+1.0, -1.0):
        if abs(a2) < 1e-12:
            lam = -a0 / a1 if a1 != 0 else 0.0
        else:
            lam = (-a1 + sgn * np.sqrt(disc)) / (2.0 * a2)
        u = lam * e + f
        u[3] = -u[3]
        res = np.linalg.norm(np.linalg.norm(sat_pos - u[:3], axis=1)
                             + u[3] - pr)
        if res < best_res:
            best, best_res = u, res
    return best


def _rotate_sat(pos: np.ndarray, tau: float) -> np.ndarray:
    """Rotate a satellite ECEF position by Earth rotation during flight tau."""
    theta = C.OMEGA_EARTH_DOT * tau
    c, s = np.cos(theta), np.sin(theta)
    return np.array([c * pos[0] + s * pos[1], -s * pos[0] + c * pos[1], pos[2]])


def _eph_lookup(ephemerides: dict, o: ObsInput):
    """Ephemeris keyed by (system, prn), falling back to bare prn (legacy
    single-system callers)."""
    eph = ephemerides.get((o.system, o.prn))
    if eph is None and o.system == "G":
        eph = ephemerides.get(o.prn)
    return eph


def solve_pvt(obs: list[ObsInput], ephemerides: dict,
              iono: IonoParams | None = None,
              apply_tropo: bool = True, n_iter: int = 8,
              el_mask_rad: float = np.deg2rad(5.0),
              sbas_lt: dict | None = None,
              sbas_iono=None) -> PvtSolution:
    """Iterated WLS single-point solution at one receiver epoch.

    Multi-constellation: one receiver-clock state per system present
    (x = [p, c*dt_sys0, c*dt_sys1, ...]); each system's inter-system bias
    (incl. GGTO / BDT offsets) is absorbed by its own clock column, matching
    the reference's rtklib pntpos state layout (rtklib_pntpos.cc NX=3+NSYS).

    SBAS corrections (reference rtklib_sbas.cc sbssatcorr/sbsioncorr):
    ``sbas_lt`` maps (system, prn) -> LongTermCorrection applied to the
    broadcast satellite position/clock; ``sbas_iono`` is a SbasIonoGrid
    whose slant delay is PREFERRED over the Klobuchar model wherever the
    pierce point is covered (DO-229 precedence).
    """
    usable = [o for o in obs if _eph_lookup(ephemerides, o) is not None]
    systems = sorted({o.system for o in usable})
    n_clk = len(systems)
    if len(usable) < 3 + max(n_clk, 1):
        return PvtSolution(valid=False, n_sats=len(usable))

    n = len(usable)
    sys_idx = np.array([systems.index(o.system) for o in usable])
    sat_pos = np.zeros((n, 3))
    sat_vel = np.zeros((n, 3))
    dts = np.zeros(n)
    ddts = np.zeros(n)
    tgd = np.zeros(n)
    for i, o in enumerate(usable):
        eph = _eph_lookup(ephemerides, o)
        dt_sv = eph.clock_offset(o.t_tx_sv)
        t_gps = o.t_tx_sv - dt_sv
        p, v = eph.position_velocity(t_gps)
        if sbas_lt:
            corr = sbas_lt.get((o.system, o.prn))
            if corr is not None:
                dp, ddt = corr.at(o.t_tx_sv)
                p = p + dp
                dt_sv += ddt
        sat_pos[i] = p
        sat_vel[i] = v
        dts[i] = dt_sv
        ddts[i] = (getattr(eph, "af1", 0.0)
                   + 2.0 * getattr(eph, "af2", 0.0)
                   * (o.t_tx_sv - getattr(eph, "toc", 0.0)))
        tgd[i] = getattr(eph, "tgd", 0.0)

    pr_raw = np.array([o.pseudorange_m for o in usable])
    # SV clock correction (incl. relativistic); TGD applies on L1
    pr = pr_raw + C.SPEED_OF_LIGHT_M_S * (dts - tgd)

    # initial guess: Bancroft on clock-corrected ranges (rough rotation),
    # single common clock — per-system clocks separate during the WLS
    tau0 = pr / C.SPEED_OF_LIGHT_M_S
    sp0 = np.stack([_rotate_sat(sat_pos[i], tau0[i]) for i in range(n)])
    nx = 3 + n_clk
    x = np.zeros(nx)
    try:
        u0 = bancroft(sp0, pr)
        x[:3] = u0[:3]
        x[3:] = u0[3]
    except np.linalg.LinAlgError:
        pass

    week = 0
    used = np.ones(n, bool)
    h = np.zeros((n, nx))
    resid = np.zeros(n)
    w = np.ones(n)
    for it in range(n_iter):
        lat, lon, hgt = geodesy.ecef_to_geodetic(x[:3])
        for i in range(n):
            tau = np.linalg.norm(sat_pos[i] - x[:3]) / C.SPEED_OF_LIGHT_M_S
            sp = _rotate_sat(sat_pos[i], tau)
            rho = np.linalg.norm(sp - x[:3])
            los = (sp - x[:3]) / rho
            corr = 0.0
            if it >= 2 and np.isfinite(hgt) and -1e3 < hgt < 2e4:
                az, el = geodesy.az_el(x[:3], sp)
                used[i] = el > el_mask_rad
                # RTKLIB error model (rtklib_pntpos.cc varerr): pseudorange
                # variance ~ eratio^2*(a^2 + b^2/sin(el)) with a=b; the
                # common scale cancels in WLS so weight = 1/(1 + 1/sin el).
                # Validated against the reference's real-data oracle
                # (tests/test_real_data_pvt.py) where sin^2(el) weighting
                # missed the 0.2 m budget and this model meets it.
                s_el = max(np.sin(el), 1e-3)
                w[i] = s_el / (s_el + 1.0)
                if not usable[i].iono_free:
                    d_l1 = None
                    if sbas_iono is not None:
                        # SBAS grid preferred over Klobuchar (DO-229);
                        # grid delays are meters, the scaler wants seconds
                        s_m = sbas_iono.slant_delay(lat, lon, az, el)
                        if s_m is not None:
                            d_l1 = s_m / C.SPEED_OF_LIGHT_M_S
                    if d_l1 is None and iono is not None and iono.valid:
                        d_l1 = atmosphere.klobuchar_delay(
                            iono.alpha, iono.beta, lat, lon, az, el,
                            usable[i].t_tx_sv)
                    if d_l1 is not None:
                        corr += atmosphere.iono_delay_scaled(
                            d_l1, usable[i].carrier_freq_hz)
                if apply_tropo:
                    corr += atmosphere.saastamoinen_delay(el, hgt, lat)
            h[i, :3] = -los
            h[i, 3:] = 0.0
            h[i, 3 + sys_idx[i]] = 1.0
            resid[i] = pr[i] - (rho + x[3 + sys_idx[i]] + corr)
        # every system must keep >= 1 usable sat, else drop its clock from
        # this epoch by zeroing those rows (rank guard)
        hw = h[used] * w[used, None]
        try:
            dx = np.linalg.lstsq(hw.T @ h[used], hw.T @ resid[used], rcond=None)[0]
        except np.linalg.LinAlgError:
            return PvtSolution(valid=False, n_sats=n)
        x += dx
        if np.linalg.norm(dx[:3]) < 1e-4:
            break

    if used.sum() < 3 + n_clk or not np.all(np.isfinite(x)):
        return PvtSolution(valid=False, n_sats=int(used.sum()))

    # velocity from Doppler: rr = -lambda * fd ; rr_pred = los.(v_sat - v_rcv)
    # + c*(ddt_rx - ddt_sv) (+ Earth-rotation term folded into rotation)
    g = np.zeros((n, 4))
    rr = np.zeros(n)
    for i, o in enumerate(usable):
        tau = np.linalg.norm(sat_pos[i] - x[:3]) / C.SPEED_OF_LIGHT_M_S
        sp = _rotate_sat(sat_pos[i], tau)
        rho = np.linalg.norm(sp - x[:3])
        los = (sp - x[:3]) / rho
        lam = C.SPEED_OF_LIGHT_M_S / o.carrier_freq_hz
        # broadcast-model satellite velocity is already ECEF (rotating frame);
        # only rotate it into the reception-epoch frame — do NOT add omega x r
        sv = _rotate_sat(sat_vel[i], tau)
        rr[i] = -lam * o.doppler_hz + C.SPEED_OF_LIGHT_M_S * ddts[i] - los @ sv
        g[i] = [-los[0], -los[1], -los[2], 1.0]
    gw = g[used] * w[used, None]
    try:
        vsol = np.linalg.lstsq(gw.T @ g[used], gw.T @ rr[used], rcond=None)[0]
    except np.linalg.LinAlgError:
        vsol = np.zeros(4)

    lat, lon, hgt = geodesy.ecef_to_geodetic(x[:3])
    los_all = np.stack([
        (_rotate_sat(sat_pos[i], np.linalg.norm(sat_pos[i] - x[:3])
                     / C.SPEED_OF_LIGHT_M_S) - x[:3]) for i in range(n)])
    los_all /= np.linalg.norm(los_all, axis=1, keepdims=True)
    d = geodesy.dops(los_all[used], x[:3])

    t_rx = usable[0].t_tx_sv + pr_raw[0] / C.SPEED_OF_LIGHT_M_S
    clk0 = x[3 + sys_idx[0]]
    # week from the SAME ephemeris whose transmit time defines tow_s (the
    # previous back-fill used an arbitrary ephemeris — wrong across mixed
    # GPS/Galileo/BDS week numbering), with half-week rollover correction
    # of tow vs toe (reference: rtklib adjweek)
    eph0 = _eph_lookup(ephemerides, usable[0])
    week = int(getattr(eph0, "week", 0))
    toe0 = float(getattr(eph0, "toe", t_rx))
    if t_rx - toe0 > C.SECONDS_PER_WEEK / 2:
        week -= 1               # tow wrapped backward relative to toe
    elif t_rx - toe0 < -C.SECONDS_PER_WEEK / 2:
        week += 1               # tow wrapped forward past the week boundary
    return PvtSolution(
        valid=True, pos_ecef=x[:3].copy(), vel_ecef=vsol[:3].copy(),
        clock_bias_s=x[3] / C.SPEED_OF_LIGHT_M_S,
        clock_drift_s_s=vsol[3] / C.SPEED_OF_LIGHT_M_S,
        system_clock_s={s: x[3 + k] / C.SPEED_OF_LIGHT_M_S
                        for k, s in enumerate(systems)},
        tow_s=t_rx - clk0 / C.SPEED_OF_LIGHT_M_S, week=week,
        n_sats=int(used.sum()), residuals_m=resid.copy(),
        used_mask=used.copy(),
        lat_rad=lat, lon_rad=lon, height_m=hgt, **d_subset(d))


def d_subset(d: dict) -> dict:
    return {k: d[k] for k in ("gdop", "pdop", "hdop", "vdop")}


# chi-square 99% quantiles by degrees of freedom (RAIM residual test)
_CHI2_99 = {1: 6.63, 2: 9.21, 3: 11.34, 4: 13.28, 5: 15.09, 6: 16.81,
            7: 18.48, 8: 20.09, 9: 21.67, 10: 23.21, 11: 24.73, 12: 26.22}


def solve_pvt_fde(obs: list[ObsInput], ephemerides: dict,
                  sigma_pr_m: float = 3.0, **kw) -> PvtSolution:
    """RAIM fault detection and exclusion around :func:`solve_pvt`
    (reference: rtklib valsol() + the single-exclusion FDE loop in pntpos).

    Chi-square test on the weighted residual sum of squares; on failure,
    re-solve with each satellite excluded and keep the best passing subset.
    Sets ``excluded_prn`` when an exclusion was applied.
    """
    def chi2(sol) -> float:
        # only satellites that entered the solution (elevation mask) count:
        # a masked satellite's residual never influenced the estimate
        if sol.residuals_m is None:
            return np.inf
        r = sol.residuals_m
        if sol.used_mask is not None:
            r = r[sol.used_mask]
        return float(np.sum((r / sigma_pr_m) ** 2))

    def dof(sol) -> int:
        n_used = (int(sol.used_mask.sum()) if sol.used_mask is not None
                  else sol.n_sats)
        return max(1, n_used - (3 + max(len(sol.system_clock_s), 1)))

    def threshold(sol) -> float:
        return _CHI2_99.get(min(dof(sol), 12), 26.22)

    sol = solve_pvt(obs, ephemerides, **kw)
    sol.excluded_prn = None
    if not sol.valid:
        return sol
    if chi2(sol) <= threshold(sol):
        return sol
    best, best_c = None, np.inf
    for skip in range(len(obs)):
        subset = obs[:skip] + obs[skip + 1:]
        s2 = solve_pvt(subset, ephemerides, **kw)
        if not s2.valid:
            continue
        c2 = chi2(s2)
        if c2 < best_c:
            best, best_c, best_skip = s2, c2, skip
    if best is not None and best_c <= threshold(best):
        best.excluded_prn = (obs[best_skip].system, obs[best_skip].prn)
        return best
    sol.excluded_prn = None
    return sol
