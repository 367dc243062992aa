"""The port's RTK rover (gnss_sdr_tpu_torch.receiver.pvt.lambda_ilsq / rtk /
rtk_filter / rtk_engine) against the JAX package's, on the CPU.

The synthetic worlds and RTCM streams of tests/test_rtk.py and
tests/test_rtk_kinematic.py, built once from a seed with numpy and the JAX
package's constellation oracle, go through both packages: LAMBDA on seeded
covariances, single-epoch double differences, the filtered static /
kinematic RTK with slips, LLI and satellites dropped and re-added, and the
RtkEngine in all five modes (instantaneous, static, kinematic, dgps,
moving_base) from RTCM byte streams each package encodes itself: MSM7,
MSM5 and MSM4 bases, a legacy 1004 base, and GLONASS (1006 + 1020 + MSM7,
and legacy 1012) and BeiDou (1006 + 1042 + MSM7) rovers fed only by the
stream. Fixed flags, integer ambiguities, ratio outcomes, baselines and
filter states must equal JAX's bit for bit (the port's modules run the
same numpy operations in the same order); each case also keeps the JAX
test's own accuracy claims.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import constants as C
from gnss_sdr_tpu.models.nav.glonass_gnav import GlonassEphemeris
from gnss_sdr_tpu.receiver.observables import ChannelObservable
from gnss_sdr_tpu.receiver.pvt import geodesy, rtcm, rtk
from gnss_sdr_tpu.receiver.pvt.rtk_engine import RtcmBaseStation
from gnss_sdr_tpu.receiver.pvt.rtk_filter import RtkFilterConfig
from gnss_sdr_tpu.utils import constellation
from torch_twin import TAGS, assert_same, modules, state, twin

torch.set_num_threads(1)   # one thread per xdist worker

LAM = C.SPEED_OF_LIGHT_M_S / 1_575_420_000.0
TRUE_LLH = (np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
T0 = 354000.0


def _pkg(tag):
    return modules(tag, lam="receiver.pvt.lambda_ilsq", rtk="receiver.pvt.rtk",
                   filt="receiver.pvt.rtk_filter", rtcm="receiver.pvt.rtcm",
                   eng="receiver.pvt.rtk_engine")


def _both(run, *args):
    """``run(tag, *args)`` for each package; asserts the results equal and
    returns the port's."""
    got = {tag: run(tag, *args) for tag in TAGS}
    assert_same(got["jax"], got["port"])
    return got["port"]


@pytest.fixture(scope="module")
def world():
    ephs = constellation.almanac_constellation()
    base = geodesy.geodetic_to_ecef(*TRUE_LLH)
    vis = constellation.visible_sats(ephs, base, T0, el_mask_deg=10.0)
    prns = [p for p, _, _ in vis[:8]]
    return {("G", p): ephs[p] for p in prns}, base, prns


def _obs_at(ephs, prns, pos, t, n_amb, rng, pr_sigma=0.3, cp_sigma_cyc=0.005,
            clock_bias_s=0.0, slip_cycles=None, vel_ecef=None):
    """tests/test_rtk_kinematic.py's observations of ``prns`` from ``pos``
    at GPS time t, with integer ambiguities, slips and the Doppler of the
    range rate (RINEX sign)."""
    out = []
    for prn in prns:
        eph = ephs[("G", prn)]
        o = constellation.simulate_observation(eph, pos, t,
                                               rcv_clock_bias_s=clock_bias_s)
        extra = (slip_cycles or {}).get(prn, 0)
        pos2 = pos if vel_ecef is None else pos + vel_ecef
        o2 = constellation.simulate_observation(eph, pos2, t + 1.0,
                                                rcv_clock_bias_s=clock_bias_s)
        dop = -(o2.pseudorange_m - o.pseudorange_m) / LAM
        out.append(rtk.RtkObs(
            prn=prn, system="G",
            pseudorange_m=o.pseudorange_m + rng.normal(0, pr_sigma),
            carrier_phase_cycles=(o.pseudorange_m / LAM + n_amb[prn] + extra
                                  + rng.normal(0, cp_sigma_cyc)),
            doppler_hz=dop, t_tx_sv=o.t_tx_sv))
    return out


# ---------------------------------------------------------------- LAMBDA

def _lambda_run(tag, cases):
    lam = _pkg(tag).lam
    out = []
    for a_float, q in cases:
        cands, norms = lam.lambda_ils(a_float, q)
        out.append((cands, norms, lam.ratio_test(norms, threshold=3.0),
                    lam.bootstrap_success_rate(q)))
    return out


@pytest.mark.parametrize("seed", [3, 5, 7, 11])
def test_lambda_equals_jax(seed):
    """20 seeded float vectors on small correlated covariances (and one
    carrying no integer information): the same two candidates, norms,
    ratio-test outcomes and bootstrapped success rates; the best candidate
    is the injected integer vector."""
    rng = np.random.default_rng(seed)
    cases, truth = [], []
    for _ in range(20):
        n = int(rng.integers(3, 9))
        a_true = rng.integers(-50, 50, n).astype(float)
        m = rng.normal(0, 1.0, (n, n))
        q = m @ m.T * 1e-4 + np.eye(n) * 1e-4
        cases.append((a_true + np.linalg.cholesky(q) @ rng.normal(0, 1, n),
                      q))
        truth.append(a_true)
    a_true = rng.integers(-10, 10, 6).astype(float)
    cases.append((a_true + rng.normal(0, 5.0, 6), np.eye(6) * 25.0))
    got = _both(_lambda_run, cases)
    for (cands, norms, _, _), a in zip(got, truth):
        assert len(cands) == 2 and norms[0] <= norms[1]
        np.testing.assert_array_equal(cands[0], a)
    assert not got[-1][2]               # the noise case fails the ratio


# ----------------------------------------------------- single-epoch RTK

def _make_obs(ephs, prns, rcv_ecef, n_amb, *, clock_bias_s, rng,
              pr_sigma=0.3, cp_sigma_cyc=0.005):
    """tests/test_rtk.py's observations at T0."""
    out = []
    for prn in prns:
        o = constellation.simulate_observation(
            ephs[("G", prn)], rcv_ecef, T0, rcv_clock_bias_s=clock_bias_s)
        pr = o.pseudorange_m + rng.normal(0, pr_sigma)
        cp = o.pseudorange_m / LAM + n_amb[prn] + rng.normal(0, cp_sigma_cyc)
        out.append(rtk.RtkObs(prn=prn, pseudorange_m=pr,
                              carrier_phase_cycles=cp, t_tx_sv=o.t_tx_sv))
    return out


def _solve_run(tag, rover, base, base_ecef, ephs, sigma):
    sol = _pkg(tag).rtk.solve_rtk(twin(rover, tag), twin(base, tag),
                                  base_ecef, twin(ephs, tag),
                                  sigma_pr_m=sigma)
    return sol


@pytest.mark.parametrize("case", ["fixed", "short_set", "noisy_code"])
def test_solve_rtk_equals_jax(world, case):
    """tests/test_rtk.py's three single-epoch cases: smoothed code fixes
    at cm level, four satellites are refused, raw code declines the
    ratio test and keeps a metre-level float."""
    ephs, base_ecef, prns = world
    lat, lon, _ = TRUE_LLH
    rover_ecef = base_ecef + geodesy.enu_to_ecef_offset(
        np.array([37.2, -12.5, 3.1]), lat, lon)
    if case == "short_set":
        rng = np.random.default_rng(13)
        zero = {p: 0 for p in prns}
        rover = _make_obs(ephs, prns[:4], base_ecef, zero, clock_bias_s=0.0,
                          rng=rng)
        base = _make_obs(ephs, prns[:4], base_ecef, zero, clock_bias_s=0.0,
                         rng=rng)
        sol = _both(_solve_run, rover, base, base_ecef, ephs, 0.5)
        assert not sol.valid
        return
    rng = np.random.default_rng(11)
    span, sigma = ((2_000_000, 0.03) if case == "fixed" else (100, 0.5))
    n_rov = {p: int(rng.integers(-span, span)) for p in prns}
    n_bas = {p: int(rng.integers(-span, span)) for p in prns}
    rover = _make_obs(ephs, prns, rover_ecef, n_rov, clock_bias_s=3.1e-4,
                      rng=rng, pr_sigma=sigma)
    base = _make_obs(ephs, prns, base_ecef, n_bas, clock_bias_s=-1.7e-4,
                     rng=rng, pr_sigma=sigma)
    sol = _both(_solve_run, rover, base, base_ecef, ephs, sigma)
    truth = rover_ecef - base_ecef
    assert sol.valid
    if case == "fixed":
        assert sol.fixed and len(sol.ambiguities) == len(prns) - 1
        assert np.linalg.norm(sol.baseline_m - truth) < 0.02
    else:
        assert not sol.fixed
        assert np.linalg.norm(sol.float_baseline_m - truth) < 3.0


# ------------------------------------------------------- filtered RTK

def _filter_run(tag, base_ecef, ephs, cfg, epochs):
    """An RtkFilter over ``epochs`` of (rover, base, tow, lli); the
    per-epoch solutions, slip counts and state sizes and the final state."""
    P = _pkg(tag)
    filt = P.filt.RtkFilter(base_ecef, twin(ephs, tag), twin(cfg, tag))
    trace = []
    for rover, base, t, lli in epochs:
        sol = filt.update(twin(rover, tag), twin(base, tag), t, lli=lli)
        trace.append((sol, filt.n_slips, len(filt.x), dict(filt.sat_index)))
    return trace, state(filt)


def _filter_epochs(world, case):
    ephs, base_ecef, prns = world
    lat, lon, _ = TRUE_LLH
    epochs, truth = [], []
    if case == "moving_rover":
        v_ecef = geodesy.enu_to_ecef_offset(np.array([3.0, -1.5, 0.0]),
                                            lat, lon)
        p0 = base_ecef + geodesy.enu_to_ecef_offset(
            np.array([50.0, 20.0, 1.0]), lat, lon)
        rng = np.random.default_rng(7)
        cfg = RtkFilterConfig(mode="kinematic", sigma_pr_m=0.1,
                              fix_and_hold=True)
    elif case == "cycle_slip":
        p0 = base_ecef + geodesy.enu_to_ecef_offset(
            np.array([10.0, 5.0, 0.0]), lat, lon)
        rng = np.random.default_rng(13)
        cfg = RtkFilterConfig(mode="static", sigma_pr_m=0.1,
                              fix_and_hold=True)
    elif case == "lli":
        p0 = base_ecef + 5.0
        rng = np.random.default_rng(17)
        cfg = RtkFilterConfig(mode="static")
    else:
        p0 = base_ecef + 8.0
        rng = np.random.default_rng(71)
        cfg = RtkFilterConfig(mode="static", sigma_pr_m=0.1,
                              fix_and_hold=True)
    span = 5000 if case == "drop_readd" else 2_000_000
    n_rov = {p: int(rng.integers(-span, span)) for p in prns}
    n_bas = {p: int(rng.integers(-span, span)) for p in prns}
    n_ep = {"moving_rover": 30, "cycle_slip": 30, "lli": 6,
            "drop_readd": 24}[case]
    for k in range(n_ep):
        t = T0 + 1.0 * k
        lli, use, kw_r, kw_b = None, prns, {}, {}
        pos = p0
        if case == "moving_rover":
            pos = p0 + v_ecef * k
            kw_r = dict(pr_sigma=0.1, clock_bias_s=1.3e-4, vel_ecef=v_ecef)
            kw_b = dict(pr_sigma=0.1, clock_bias_s=-0.6e-4)
        elif case == "cycle_slip":
            kw_r = dict(pr_sigma=0.1,
                        slip_cycles={prns[2]: 7} if k >= 15 else None)
            kw_b = dict(pr_sigma=0.1)
        elif case == "lli":
            lli = {("G", prns[0])} if k == 3 else None
        else:
            use = prns[:6] if 8 <= k < 16 else prns
            kw_r = kw_b = dict(pr_sigma=0.1)
        rover = _obs_at(ephs, use, pos, t, n_rov, rng, **kw_r)
        base = _obs_at(ephs, use, base_ecef, t, n_bas, rng, **kw_b)
        epochs.append((rover, base, t, lli))
        truth.append(pos)
    return cfg, epochs, truth


@pytest.mark.parametrize("case", ["moving_rover", "cycle_slip", "lli",
                                  "drop_readd"])
def test_rtk_filter_equals_jax(world, case):
    """tests/test_rtk_kinematic.py's filter cases: a constant-velocity
    kinematic rover, a +7-cycle slip on one satellite from epoch 15, an
    LLI-forced reset, two satellites dropped for 8 epochs and re-added."""
    ephs, base_ecef, prns = world
    cfg, epochs, truth = _filter_epochs(world, case)
    trace, _ = _both(_filter_run, base_ecef, ephs, cfg, epochs)
    sols = [t[0] for t in trace]
    assert all(s.valid for s in sols)
    errs = [np.linalg.norm(s.rover_ecef - p) for s, p in zip(sols, truth)]
    if case == "moving_rover":
        assert all(s.fixed for s in sols[2:]) and trace[-1][1] == 0
        assert max(e for s, e in zip(sols, errs) if s.fixed) < 0.03
    elif case == "cycle_slip":
        assert trace[-1][1] >= 1 and all(s.fixed for s in sols[18:])
        assert max(errs[18:]) < 0.02
    elif case == "lli":
        assert trace[3][1] >= 1
    else:
        assert trace[9][2] == 3 + 6
        assert set(trace[9][3]) == {("G", p) for p in prns[:6]}
        assert trace[-1][2] == 3 + len(prns) and sols[-1].fixed
        assert errs[-1] < 0.03


# -------------------------------------------------- RtkEngine over RTCM

def _chans(rover, signal="1C", **kw):
    return [ChannelObservable(
        prn=o.prn, signal=signal, t_tx_sv=o.t_tx_sv,
        pseudorange_m=o.pseudorange_m,
        carrier_phase_cycles=o.carrier_phase_cycles,
        doppler_hz=o.doppler_hz, cn0_dbhz=45.0, **kw) for o in rover]


def _msm(obs, rate=True, phase=True):
    return [rtcm.MsmObservation(
        prn=o.prn, signal_id=2, pseudorange_m=o.pseudorange_m,
        phase_range_m=o.carrier_phase_cycles * LAM if phase else 0.0,
        phase_rate_m_s=-o.doppler_hz * LAM if rate else 0.0, cn0_dbhz=44.0)
        for o in obs]


def _tow_ms(o) -> int:
    return int(round((o.t_tx_sv + o.pseudorange_m / C.SPEED_OF_LIGHT_M_S)
                     * 1e3))


def _engine_run(tag, setup, epochs, mode, sigma, piece):
    """An RtcmBaseStation fed ``setup`` (then each epoch's messages),
    encoded by the package's own codec, and an RtkEngine of ``mode`` fed
    each epoch's rover observables; the stream bytes, the solutions, the
    engine's filter state and the station's state."""
    P = _pkg(tag)

    def frames(msgs):
        return b"".join(P.rtcm.frame(getattr(P.rtcm, enc)(*twin(args, tag)))
                        for enc, args in msgs)

    station = P.eng.RtcmBaseStation()
    engine = P.eng.RtkEngine(station, sigma_pr_m=sigma, mode=mode)
    stream = frames(setup)
    for i in range(0, len(stream), piece):
        station.push_bytes(stream[i:i + piece])
    counts = []
    for msgs, chans in epochs:
        data = frames(msgs)
        station.push_bytes(data)
        stream += data
        engine.push_rover_epoch(0, twin(chans, tag))
        counts.append(len(engine.solutions))
    filt = None if engine._filter is None else state(engine._filter)
    return dict(stream=stream, counts=counts, solutions=engine.solutions,
                filter=filt, station=state(station))


def _gps_setup(ephs, prns, base_ecef, with_1005=True):
    return ([("encode_1005", (55, base_ecef))] if with_1005 else []) + [
        ("encode_1019", (ephs[("G", p)],)) for p in prns]


def _engine_case(world, case):
    """The inputs of one RtkEngine case: (setup messages, epochs of
    (messages, rover observables), mode, sigma, fragment size, truth)."""
    ephs, base_ecef, prns = world
    lat, lon, _ = TRUE_LLH
    enu = geodesy.enu_to_ecef_offset
    epochs, truth = [], []
    if case == "instantaneous":
        # tests/test_rtk.py: one MSM7 epoch, the stream cut every 37 bytes
        rover_ecef = base_ecef + enu(np.array([21.0, 8.0, -1.5]), lat, lon)
        rng = np.random.default_rng(17)
        n_rov = {p: int(rng.integers(-5000, 5000)) for p in prns}
        n_bas = {p: int(rng.integers(-5000, 5000)) for p in prns}
        base = _make_obs(ephs, prns, base_ecef, n_bas, clock_bias_s=-2e-3,
                         rng=rng, pr_sigma=0.05)
        setup = _gps_setup(ephs, prns, base_ecef) + [(
            "encode_msm7", (rtcm.MSM7_GPS, 55, _tow_ms(base[0]),
                            _msm(base, rate=False)))]
        rover = _make_obs(ephs, prns, rover_ecef, n_rov, clock_bias_s=3e-4,
                          rng=rng, pr_sigma=0.05)
        return (setup, [([], _chans(rover))], "instantaneous", 0.05, 37,
                [rover_ecef])
    if case in ("kinematic_msm7", "static_msm7", "kinematic_msm4",
                "kinematic_1004", "dgps_msm5", "moving_base"):
        seeds = {"kinematic_msm7": 61, "static_msm7": 67,
                 "kinematic_msm4": 77, "kinematic_1004": 79, "dgps_msm5": 83,
                 "moving_base": 97}
        rng = np.random.default_rng(seeds[case])
        n_ep = {"kinematic_msm7": 30, "static_msm7": 20, "kinematic_msm4": 25,
                "kinematic_1004": 20, "dgps_msm5": 10, "moving_base": 12}[case]
        v_ecef = np.zeros(3)
        if case == "kinematic_msm7":
            v_ecef = enu(np.array([2.5, -1.0, 0.0]), lat, lon)
            p0 = base_ecef + enu(np.array([30.0, 12.0, 0.5]), lat, lon)
        elif case == "moving_base":
            v_ecef = enu(np.array([4.0, 2.0, 0.0]), lat, lon)
            off = enu(np.array([12.0, 2.5, 0.8]), lat, lon)
        else:
            p0 = base_ecef + enu({"static_msm7": np.array([-14.0, 6.0, 0.2]),
                                  "kinematic_msm4": np.array([25.0, -8.0,
                                                              0.3]),
                                  "kinematic_1004": np.array([25.0, -8.0,
                                                              0.3]),
                                  "dgps_msm5": np.array([40.0, -15.0, 1.0])
                                  }[case], lat, lon)
        if case == "dgps_msm5":
            common = {p: rng.normal(0, 5.0) for p in prns}
            n_rov = n_bas = {p: 0 for p in prns}
        else:
            n_rov = {p: int(rng.integers(-5000, 5000)) for p in prns}
            small = case in ("kinematic_msm4", "kinematic_1004")
            n_bas = {p: int(rng.integers(*((-300, 300) if small
                                           else (-5000, 5000))))
                     for p in prns}
        sigma = {"dgps_msm5": 0.5}.get(case, 0.1)
        pr = {"dgps_msm5": 0.4, "moving_base": 0.03}.get(case, 0.1)
        setup = _gps_setup(ephs, prns, base_ecef,
                           with_1005=case != "moving_base")
        for k in range(n_ep):
            t = T0 + 1.0 * k
            if case == "moving_base":
                bpos = base_ecef + v_ecef * k
                pos = bpos + off
                base = _obs_at(ephs, prns, bpos, t, n_bas, rng, pr_sigma=pr,
                               vel_ecef=v_ecef)
            else:
                pos = p0 + v_ecef * k
                base = _obs_at(ephs, prns, base_ecef, t, n_bas, rng,
                               pr_sigma=pr)
            if case == "dgps_msm5":
                for o in base:
                    o.pseudorange_m += common[o.prn]
            if case == "kinematic_1004":
                msgs = [("encode_1004", (55, _tow_ms(base[0]), [
                    rtcm.LegacyObservation(
                        prn=o.prn, pseudorange_m=o.pseudorange_m,
                        phase_range_m=o.carrier_phase_cycles * LAM,
                        lock_time_s=100.0 + k, cn0_dbhz=44.0)
                    for o in base]))]
            else:
                msg = {"kinematic_msm4": rtcm.MSM4_GPS,
                       "dgps_msm5": rtcm.MSM5_GPS}.get(case, rtcm.MSM7_GPS)
                msgs = [("encode_msm", (msg, 55, _tow_ms(base[0]), _msm(
                    base, rate=msg == rtcm.MSM7_GPS,
                    phase=case != "dgps_msm5")))]
            rover = _obs_at(ephs, prns, pos, t, n_rov, rng, pr_sigma=pr,
                            vel_ecef=v_ecef)
            if case == "dgps_msm5":
                for o in rover:
                    o.pseudorange_m += common[o.prn]
            epochs.append((msgs, _chans(rover)))
            truth.append(off if case == "moving_base" else pos)
        mode = case.split("_")[0]
        mode = {"moving": "moving_base"}.get(mode, mode)
        return setup, epochs, mode, sigma, 4096, truth
    raise KeyError(case)


ENGINE_CASES = ["instantaneous", "kinematic_msm7", "static_msm7",
                "kinematic_msm4", "kinematic_1004", "dgps_msm5",
                "moving_base"]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_rtk_engine_modes_equal_jax(world, case):
    """RtkEngine from RTCM streams in each mode: instantaneous (one MSM7
    epoch fragmented every 37 bytes), static and kinematic over MSM7,
    kinematic over an MSM4 base (no phase rate: the code-minus-carrier slip
    test) and over a legacy 1004 base, dgps over MSM5 code with 5 m of
    common-mode error, moving_base without a 1005 position."""
    setup, epochs, mode, sigma, piece, truth = _engine_case(world, case)
    got = _both(_engine_run, setup, epochs, mode, sigma, piece)
    sols = got["solutions"]
    assert sols, "no RTK solution"
    last = sols[-1]
    if case == "instantaneous":
        assert last.fixed and np.linalg.norm(
            last.baseline_m - (truth[0] - world[1])) < 0.05
        return
    n = len(epochs)
    # the solution of each epoch that produced one, against its truth
    at = [truth[k] for k in range(n) if got["counts"][k] > (
        got["counts"][k - 1] if k else 0)]
    assert len(at) == len(sols)
    if mode == "moving_base":
        errs = [np.linalg.norm(s.baseline_m - p) for s, p in zip(sols, at)]
        fixed = [e for s, e in zip(sols, errs) if s.fixed]
        assert len(sols) >= 10 and len(fixed) >= 3 and max(fixed) < 0.05
        return
    errs = [np.linalg.norm(s.rover_ecef - p) for s, p in zip(sols, at)]
    if mode == "dgps":
        assert len(sols) >= 8 and not last.fixed
        assert float(np.mean(errs[-5:])) < 2.0
        return
    fixed = [e for s, e in zip(sols, errs) if s.fixed]
    assert got["filter"] is not None and len(fixed) >= 10
    assert max(fixed[3:]) < 0.06
    if case in ("kinematic_msm4", "kinematic_1004"):
        assert got["filter"]["n_slips"] == 0


def _glonass_case():
    """tests/test_rtk_kinematic.py's GLONASS rover fed only by the stream:
    1006, 1020 state vectors, then MSM7_GLO epochs (or legacy 1012 with
    ``legacy``) with the FDMA channels in the extended info."""
    lat, lon, _ = TRUE_LLH
    base_ecef = geodesy.geodetic_to_ecef(*TRUE_LLH)
    t0 = 40000.0
    tb = 900.0 * round(t0 / 900.0)
    slots = {3: 5, 9: -2, 14: 0, 17: 4, 21: -4}
    kep = constellation.almanac_constellation()
    vis = constellation.visible_sats(kep, base_ecef, 352800.0,
                                     el_mask_deg=15.0)
    prns = [p for p, _, _ in vis[:5]]
    gephs = {}
    for prn, (slot, k) in zip(prns, slots.items()):
        p, v = kep[prn].position_velocity(352800.0 + (tb - t0))
        gephs[("R", slot)] = GlonassEphemeris(
            slot=slot, freq_slot=k, tb_s=tb, pos_m=tuple(p),
            vel_m_s=tuple(v), acc_m_s2=(0.0, 0.0, 0.0))
    setup = [("encode_1006", (12, base_ecef, 1.2))] + [
        ("encode_1020", (e,)) for e in gephs.values()]
    station = RtcmBaseStation()
    station.push_bytes(b"".join(rtcm.frame(getattr(rtcm, enc)(*a))
                                for enc, a in setup))
    return base_ecef, t0, slots, station, setup


def _pure_rtcm_case(system, legacy=False):
    """The GLONASS or BeiDou pure-RTCM rover's inputs (tests/
    test_rtk_kinematic.py), each epoch's base observations as MSM7 (or
    GLONASS legacy 1012)."""
    lat, lon, _ = TRUE_LLH
    signal = "1G" if system == "R" else "B1"
    spec = C.SIGNALS[signal]
    if system == "R":
        base_ecef, t0, slots, station, setup = _glonass_case()
        keys = list(slots.items())
        rng = np.random.default_rng(5)
        n_rov = {s: int(rng.integers(-200, 200)) for s in slots}
        n_bas = {s: int(rng.integers(-200, 200)) for s in slots}
        rover_pos = base_ecef + geodesy.enu_to_ecef_offset(
            np.array([18.0, -6.0, 0.4]), lat, lon)
    else:
        base_ecef = geodesy.geodetic_to_ecef(*TRUE_LLH)
        t0 = 352800.0
        kep = constellation.almanac_constellation()
        vis = constellation.visible_sats(kep, base_ecef, t0,
                                         el_mask_deg=15.0)
        keys = [(p, 0) for p, _, _ in vis[:5]]
        for p, _ in keys:
            e = kep[p]
            e.gm, e.toe, e.toc = C.GM_EARTH_BDS, 352800.0, 352800.0
        setup = [("encode_1006", (31, base_ecef, 0.7))] + [
            ("encode_1042", (kep[p],)) for p, _ in keys]
        station = RtcmBaseStation()
        station.push_bytes(b"".join(rtcm.frame(getattr(rtcm, enc)(*a))
                                    for enc, a in setup))
        rng = np.random.default_rng(9)
        n_rov = {p: int(rng.integers(-200, 200)) for p, _ in keys}
        n_bas = {p: int(rng.integers(-200, 200)) for p, _ in keys}
        rover_pos = base_ecef + geodesy.enu_to_ecef_offset(
            np.array([-9.0, 14.0, -0.6]), lat, lon)

    def obs_of(pos, t, n_amb):
        out = []
        for sv, k in keys:
            eph = station.ephemerides[(system, sv)]   # decoded orbits only
            f = spec.carrier_freq_hz + k * spec.fdma_step_hz
            o = constellation.simulate_observation(eph, pos, t,
                                                   carrier_freq_hz=f)
            lam = C.SPEED_OF_LIGHT_M_S / f
            out.append((sv, k, o, lam, o.pseudorange_m + rng.normal(0, 0.3),
                        o.pseudorange_m / lam + n_amb[sv]
                        + rng.normal(0, 0.01)))
        return out

    epochs = []
    n_ep = 10 if legacy else 20
    for kk in range(n_ep):
        t = t0 + 1.0 * kk
        basev = obs_of(base_ecef, t, n_bas)
        tow_ms = int(round((basev[0][2].t_tx_sv
                            + basev[0][4] / C.SPEED_OF_LIGHT_M_S) * 1e3))
        if legacy:
            # 1012's epoch is GLONASS time of day (UTC + 3 h)
            tod = rtcm.gps_tow_ms_to_glonass_epoch(tow_ms) & ((1 << 27) - 1)
            msgs = [("encode_1012", (12, tod, [rtcm.LegacyObservation(
                prn=sv, pseudorange_m=pr, phase_range_m=cp * lam,
                lock_time_s=50.0 + kk, cn0_dbhz=44.0, freq_slot=k)
                for sv, k, o, lam, pr, cp in basev]))]
        else:
            msgs = [("encode_msm", (
                rtcm.MSM7_GLO if system == "R" else rtcm.MSM7_BDS,
                12 if system == "R" else 31, tow_ms, [rtcm.MsmObservation(
                    prn=sv, signal_id=2, pseudorange_m=pr,
                    phase_range_m=cp * lam,
                    phase_rate_m_s=-o.doppler_hz * lam, cn0_dbhz=44.0,
                    freq_slot=k) for sv, k, o, lam, pr, cp in basev]))]
        roverv = obs_of(rover_pos, t, n_rov)
        epochs.append((msgs, [ChannelObservable(
            prn=sv, signal=signal, t_tx_sv=o.t_tx_sv, pseudorange_m=pr,
            carrier_phase_cycles=cp, doppler_hz=o.doppler_hz, cn0_dbhz=45.0,
            carrier_freq_hz=spec.carrier_freq_hz + k * spec.fdma_step_hz)
            for sv, k, o, lam, pr, cp in roverv]))
    return setup, epochs, rover_pos


@pytest.mark.parametrize("case", ["glonass_msm7", "beidou_msm7",
                                  "glonass_1012"])
def test_pure_rtcm_rovers_equal_jax(case):
    """GLONASS and BeiDou kinematic rovers whose base, orbits and
    observations all come from the stream: the same solutions as JAX's,
    and the MSM7 rovers' float baselines within 0.5 m after 20 epochs
    (tests/test_rtk_kinematic.py). The legacy 1012 base (time of day only,
    its day resolved against the rover epoch) is held to JAX's results."""
    system = "R" if case.startswith("glonass") else "C"
    setup, epochs, rover_pos = _pure_rtcm_case(system,
                                               legacy=case.endswith("1012"))
    got = _both(_engine_run, setup, epochs, "kinematic", 0.3, 4096)
    assert got["station"]["base_ecef"] is not None
    if case.endswith("msm7"):
        assert got["solutions"]
        err = np.linalg.norm(got["solutions"][-1].rover_ecef - rover_pos)
        assert err < 0.5, f"float RTK error {err:.2f} m"
    else:
        assert [d for *_, d in got["station"]["epochs"]] == [False] * 10
