"""The port's precise-positioning modules (gnss_sdr_tpu_torch.receiver.pvt.
tides / sp3 / ionex / corrections / ppp / ppp_ar / ppp_engine) against the
JAX package's, on the CPU.

The inputs of tests/test_{tides,sp3,ionex,ppp,ppp_ar,ppp_fidelity}.py and
the PPP half of tests/test_rtk_kinematic.py are built once, from a seed
with numpy and the JAX package's constellation oracle, and go through both
packages: the Sun and Moon, the solid tide, the SP3 and IONEX writers (their
files byte for byte), readers and interpolators, the observation-model
corrections and the ANTEX parse (its file under tmp_path), the float PPP
filter (static, kinematic, slips), PPP-AR (wide-lane / narrow-lane fixing,
the slip reset of the Melbourne-Wübbena average, the code-bias gate) and
the PppEngine on receiver observables (dual frequency, phase wind-up, SSR
code biases). Every number, flag and AR decision must equal JAX's bit for
bit; each case also keeps the JAX test's own claims.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import constants as C
from gnss_sdr_tpu.receiver.observables import ChannelObservable
from gnss_sdr_tpu.receiver.pvt import corrections, geodesy, ppp, ppp_ar
from gnss_sdr_tpu.receiver.pvt import rtcm
from gnss_sdr_tpu.utils import constellation
from torch_twin import TAGS, assert_same, modules, state, twin

torch.set_num_threads(1)   # one thread per xdist worker

TRUE_LLH = (np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
F1 = 1_575_420_000.0
F2 = 1_227_600_000.0
F5 = 1_176_450_000.0
LAM1 = C.SPEED_OF_LIGHT_M_S / F1
LAM2 = C.SPEED_OF_LIGHT_M_S / F2
LAM5 = C.SPEED_OF_LIGHT_M_S / F5
RCV = geodesy.geodetic_to_ecef(*TRUE_LLH)


def _pkg(tag):
    return modules(tag, tides="receiver.pvt.tides", sp3="receiver.pvt.sp3",
                   ionex="receiver.pvt.ionex", solver="receiver.pvt.solver",
                   corr="receiver.pvt.corrections", ppp="receiver.pvt.ppp",
                   ppp_ar="receiver.pvt.ppp_ar",
                   engine="receiver.pvt.ppp_engine")


def _both(run, *args):
    """``run(tag, *args)`` for each package; asserts the results equal and
    returns the port's."""
    got = {tag: run(tag, *args) for tag in TAGS}
    assert_same(got["jax"], got["port"])
    return got["port"]


def _world(t0, el_mask=10.0, n=8, tgd_zero=False):
    ephs = constellation.almanac_constellation()
    if tgd_zero:
        for e in ephs.values():
            e.tgd = 0.0
    vis = constellation.visible_sats(ephs, RCV, t0, el_mask_deg=el_mask)
    prns = [p for p, _, _ in vis[:n]]
    return {("G", p): ephs[p] for p in prns}, prns


# ------------------------------------------------------------ tides

def _tides_run(tag, week, tows):
    t = _pkg(tag).tides
    return dict(sun_moon=[t.sun_moon_ecef(week, tow) for tow in tows],
                tide=[t.solid_tide_displacement(RCV, week, tow)
                      for tow in tows])


def test_tides_equal_jax():
    """Sun and Moon positions and the degree-2 solid tide over a day in
    15 min steps (tests/test_tides.py): equal; 2-60 cm, radial-dominated,
    several sign changes, under 5 mm in 30 s."""
    tows = np.concatenate([352800.0 + 900.0 * np.arange(96), [352830.0]])
    got = _both(_tides_run, 2245, tows)
    sun, moon = got["sun_moon"][0]
    assert abs(np.linalg.norm(sun) - 1.496e11) < 0.05e11
    assert 3.5e8 < np.linalg.norm(moon) < 4.1e8
    d = np.stack(got["tide"][:96])
    mag = np.linalg.norm(d, axis=1)
    radial = d @ (RCV / np.linalg.norm(RCV))
    assert 0.02 < mag.max() < 0.6 and np.abs(radial).max() > 0.6 * mag.max()
    assert np.sum(np.sign(radial[1:]) != np.sign(radial[:-1])) >= 2
    assert np.linalg.norm(got["tide"][0] - got["tide"][-1]) < 0.005


# -------------------------------------------------------------- SP3

T_SP3 = 354000.0


@pytest.fixture(scope="module")
def sp3_epochs():
    """tests/test_sp3.py's 2 h of 5 min SP3 epochs of the almanac orbits,
    the clock referenced to the observed signal (broadcast minus TGD)."""
    ephs, prns = _world(T_SP3)
    epochs = []
    for tow in T_SP3 + 300.0 * np.arange(-12, 13):
        sats = {}
        for p in prns:
            e = ephs[("G", p)]
            sats[("G", p)] = (e.position_velocity(tow)[0],
                              e.clock_offset(tow) - e.tgd)
        epochs.append((float(tow), sats))
    return ephs, prns, epochs


def _sp3_run(tag, tmp_path, ephs, prns, epochs):
    P = _pkg(tag)
    path = tmp_path / f"{tag}.sp3"
    P.sp3.write_sp3(path, epochs, 245)
    pre = P.sp3.read_sp3(path)
    interp = {key: [(e.position_velocity(T_SP3 + dt), e.clock_offset(
        T_SP3 + dt)) for dt in (37.0, 151.0, 299.0, -211.0, -3500.0)]
        for key, e in pre.items()}
    obs = [constellation.simulate_observation(ephs[("G", p)], RCV, T_SP3,
                                              rcv_clock_bias_s=1e-4)
           for p in prns]
    sol = P.solver.solve_pvt(twin(obs, tag), pre, iono=None,
                             apply_tropo=False)
    fields = ("valid", "pos_ecef", "vel_ecef", "clock_bias_s",
              "clock_drift_s_s", "n_sats", "gdop", "pdop", "residuals_m")
    return dict(text=path.read_text(), keys=sorted(pre), interp=interp,
                sol={k: getattr(sol, k) for k in fields})


def test_sp3_equals_jax(tmp_path, sp3_epochs):
    """The SP3 file written byte for byte as JAX writes it, read back to
    the same records, the same Lagrange interpolation (position, velocity,
    clock) off the epochs, and the same single-point fix with the SP3
    provider in the solver; the orbit within 2 cm of the Kepler truth and
    the fix within 5 cm."""
    ephs, prns, epochs = sp3_epochs
    got = _both(_sp3_run, tmp_path, ephs, prns, epochs)
    assert got["keys"] == sorted(("G", p) for p in prns)
    for (pos, vel), _ in got["interp"][("G", prns[0])][:4]:
        assert np.isfinite(pos).all() and np.isfinite(vel).all()
    (pos, _), _ = got["interp"][("G", prns[0])][0]
    truth, _ = ephs[("G", prns[0])].position_velocity(T_SP3 + 37.0)
    assert np.linalg.norm(pos - truth) < 0.02
    assert got["sol"]["valid"]
    assert np.linalg.norm(got["sol"]["pos_ecef"] - RCV) < 0.05


# ------------------------------------------------------------ IONEX

def _ionex_maps(P):
    lats = np.arange(87.5, -87.6, -2.5)
    lons = np.arange(-180.0, 180.1, 5.0)
    epochs = np.array([0.0, 7200.0, 14400.0])
    tec = np.zeros((len(epochs), len(lats), len(lons)))
    for ti, t in enumerate(epochs):
        for li, la in enumerate(lats):
            tec[ti, li, :] = (10.0 + 8.0 * np.cos(np.deg2rad(la))
                              * np.cos(np.deg2rad(lons - 20.0 * ti))
                              + 0.001 * t / 3600.0)
    return P.ionex.IonexMaps(epochs_s=epochs, lats_deg=lats, lons_deg=lons,
                             tec=tec)


def _ionex_run(tag, tmp_path):
    P = _pkg(tag)
    maps = _ionex_maps(P)
    path = tmp_path / f"{tag}.inx"
    P.ionex.write_ionex(path, maps)
    rd = P.ionex.read_ionex(path)
    lat, lon = TRUE_LLH[:2]
    pts = [(t, la, lo) for t in (0.0, 3600.0, 9000.0, 14400.0)
           for la in (47.5, 41.3, 0.0, -33.3) for lo in (15.0, 1.98, -179.0)]
    return dict(
        text=path.read_text(), read=state(rd),
        vtec=[m.vtec(*p) for m in (maps, rd) for p in pts],
        slant=[maps.slant_delay_m(t, lat, lon, az, el)
               for t in (0.0, 5000.0) for az in (0.0, 1.0, 4.0)
               for el in (np.pi / 2, np.deg2rad(45.0), np.deg2rad(15.0))])


def test_ionex_equals_jax(tmp_path):
    """The IONEX file written byte for byte as JAX writes it, read back to
    the same maps, and the same vertical TEC and slant delays (tests/
    test_ionex.py's synthetic field); 0.1 TECU quantization, the zenith
    delay at L1 ~0.162 m/TECU, a low satellite's delay 1.5-3.5x it."""
    got = _both(_ionex_run, tmp_path)
    np.testing.assert_allclose(got["read"]["tec"],
                               _ionex_maps(_pkg("port")).tec, atol=0.06)
    d_zen, d_low = got["slant"][0], got["slant"][5]
    assert 1.5 * d_zen < d_low < 3.5 * d_zen


# ------------------------------------------------------- corrections

ANTEX = """\
     1.4            M                                           ANTEX VERSION / SYST
A                                                           PCV TYPE / REFANT
                                                            END OF HEADER
                                                            START OF ANTENNA
TESTANT  NONE                                               TYPE / SERIAL NO
     0.0  90.0   5.0                                        ZEN1 / ZEN2 / DZEN
   G01                                                      START OF FREQUENCY
      2.50      1.20     80.00                              NORTH / EAST / UP
   NOAZI    0.0    0.3    0.8    1.5    2.0    2.6    3.0    3.3    3.5    3.6    3.6    3.5    3.3    3.0    2.6    2.0    1.5    0.8    0.3
                                                            END OF FREQUENCY
                                                            END OF ANTENNA
"""


def _corrections_run(tag, antex_path, sats, t0):
    corr = _pkg(tag).corr
    out = dict(sun=[corr.sun_position_ecef(t0 + 1800.0 * k)
                    for k in range(13)])
    out["axes"] = [corr.satellite_body_axes(s, out["sun"][k % 13])
                   for k, s in enumerate(sats)]
    out["pco"] = [corr.satellite_antenna_offset(s, out["sun"][0])
                  for s in sats]
    out["windup"] = []
    for s in sats:
        w = None
        for k in range(10):
            w = corr.phase_windup_cycles(s + 1e3 * k, out["sun"][k], RCV,
                                         TRUE_LLH[0], TRUE_LLH[1],
                                         prev_cycles=w)
            out["windup"].append(w)
    ant = corr.parse_antex_receiver(antex_path, "TESTANT  NONE")
    out["antenna"] = ant
    out["antenna_corr"] = [ant.correction_m(az, np.deg2rad(el))
                           for az in (0.0, 1.3, 3.9) for el in
                           (90.0, 72.5, 45.0, 10.0, 3.0)]
    out["none"] = corr.parse_antex_receiver(antex_path, "OTHER  NONE")
    return out


def test_corrections_equal_jax(tmp_path):
    """The Sun's position, the satellite body axes, the satellite antenna
    offset, phase wind-up carried over 10 epochs, and the ANTEX receiver
    antenna (tests/test_ppp_fidelity.py's file) and its corrections: equal;
    1 AU, orthonormal axes, the z-PCO along the line of sight, mm -> m in
    ENU order."""
    path = tmp_path / "rcv.atx"
    path.write_text(ANTEX)
    ephs = constellation.almanac_constellation()
    t0 = 352800.0
    sats = [ephs[p].position_velocity(t0)[0] for p, _, _ in
            constellation.visible_sats(ephs, RCV, t0)[:6]]
    sats.append(RCV * (26_560e3 / np.linalg.norm(RCV)))   # straight above
    got = _both(_corrections_run, path, sats, t0)
    assert 1.45e11 < np.linalg.norm(got["sun"][0]) < 1.55e11
    for ex, ey, ez in got["axes"]:
        assert abs(ex @ ey) < 1e-12 and abs(np.linalg.norm(ez) - 1) < 1e-12
    e = (RCV - sats[-1]) / np.linalg.norm(RCV - sats[-1])
    assert abs(e @ got["pco"][-1]
               - corrections.DEFAULT_SAT_PCO_BODY_M[2]) < 0.05
    ant = got["antenna"]
    assert np.allclose(ant.pco_enu_m, (1.2e-3, 2.5e-3, 80.0e-3), atol=1e-9)
    assert abs(got["antenna_corr"][0] - 0.080) < 1e-6
    assert got["none"].pco_enu_m == (0.0, 0.0, 0.0)


# ---------------------------------------------------------- float PPP

def _filter_run(tag, cls, kwargs, ephs, epochs, slips=None):
    """``cls`` (a class name of ppp / ppp_ar) built with ``kwargs`` and
    updated with each epoch's observations; the solutions and the final
    state."""
    P = _pkg(tag)
    mod = P.ppp_ar if cls.startswith("PppAr") else P.ppp
    filt = getattr(mod, cls)(twin(ephs, tag), **kwargs)
    sols = []
    for k, (obs, kw) in enumerate(epochs):
        sols.append(filt.update(twin(obs, tag), **kw))
    return sols, state(filt)


def _ppp_obs(ephs, prns, pos, t, rng, amb, ztd, clock=0.0, pr=0.7,
             ph=0.005):
    out = []
    for p in prns:
        eph = ephs[("G", p)]
        o = constellation.simulate_observation(eph, pos, t,
                                               rcv_clock_bias_s=clock)
        az, el = geodesy.az_el(pos, eph.position_velocity(o.t_tx_sv)[0])
        trop = ztd * ppp.tropo_mapping(el)
        out.append(ppp.PppObs(
            prn=p, system="G", t_tx_sv=o.t_tx_sv,
            pr_if_m=o.pseudorange_m + trop + rng.normal(0, pr),
            phase_if_m=o.pseudorange_m + trop + amb[p] + rng.normal(0, ph)))
    return out


def test_ppp_static_equals_jax():
    """tests/test_ppp.py: 8 minutes of static iono-free code and phase with
    float ambiguities; the same solutions, the final error under 12 cm,
    the zenith delay within 3 cm, the clock within 0.3 m; no observations
    give no solution."""
    t0 = 353000.0
    ephs, prns = _world(t0, tgd_zero=True)
    rng = np.random.default_rng(5)
    amb = {p: rng.normal(0, 30.0) for p in prns}
    epochs = [(_ppp_obs(ephs, prns, RCV, t0 + k, rng, amb, 0.18, 2e-4), {})
              for k in range(480)] + [([], {})]
    sols, _ = _both(_filter_run, "PppFilter",
                    dict(x0_ecef=RCV + np.array([30.0, -20.0, 50.0])),
                    ephs, epochs)
    sol = sols[-2]
    assert sol.valid and not sols[-1].valid
    assert np.linalg.norm(sol.pos_ecef - RCV) < 0.12
    assert abs(sol.ztd_m - 0.18) < 0.03
    assert abs(sol.clock_bias_m - 2e-4 * C.SPEED_OF_LIGHT_M_S) < 0.3


def test_ppp_kinematic_equals_jax():
    """tests/test_rtk_kinematic.py's kinematic PPP: a 2.2 m/s antenna for
    8 minutes; the same solutions, RMSE of the last 2 minutes under 3.5 m
    and the last 100 s of motion within 2 %."""
    t0 = 354000.0
    ephs, prns = _world(t0)
    lat, lon, _ = TRUE_LLH
    v = geodesy.enu_to_ecef_offset(np.array([2.0, 1.0, 0.0]), lat, lon)
    rng = np.random.default_rng(23)
    amb = {p: rng.normal(0, 30.0) for p in prns}
    truth = [RCV + v * k for k in range(480)]
    epochs = [(_ppp_obs(ephs, prns, truth[k], t0 + k, rng, amb, 0.15, 1e-4),
               dict(dt_s=1.0)) for k in range(480)]
    sols, _ = _both(_filter_run, "PppFilter", dict(
        x0_ecef=RCV + np.array([20.0, -10.0, 30.0]), mode="kinematic",
        q_pos_m2_s=1.0, sigma_pr_m=0.7, sigma_phase_m=0.005), ephs, epochs)
    errs = [np.linalg.norm(s.pos_ecef - p)
            for s, p in zip(sols[-120:], truth[-120:])]
    assert float(np.sqrt(np.mean(np.square(errs)))) < 3.5
    moved = np.linalg.norm(sols[-1].pos_ecef - sols[-101].pos_ecef)
    assert moved == pytest.approx(np.linalg.norm(v) * 100.0, rel=0.02)


@pytest.fixture(scope="module")
def slip_runs():
    """tests/test_rtk_kinematic.py's slip case in both packages: 8 minutes
    of a static antenna, a 25-cycle slip on one satellite at epoch 240
    flagged (the ambiguity reset) or not, and the run without the slip;
    {case: {tag: (solutions, final state)}}."""
    t0 = 354000.0
    ephs, prns = _world(t0)
    slip_prn = prns[1]
    out = {}
    for case in ("clean", "flagged", "blind"):
        rng = np.random.default_rng(29)
        amb = {p: rng.normal(0, 30.0) for p in prns}
        epochs = []
        for k in range(480):
            if k == 240 and case != "clean":
                amb[slip_prn] += 25.0 * LAM1
            slips = ({("G", slip_prn)} if (k == 240 and case == "flagged")
                     else None)
            epochs.append((_ppp_obs(ephs, prns, RCV, t0 + k, rng, amb, 0.0),
                           dict(slips=slips)))
        out[case] = {tag: _filter_run(tag, "PppFilter", dict(
            x0_ecef=RCV + 20.0, mode="static", sigma_pr_m=0.7,
            sigma_phase_m=0.005), ephs, epochs) for tag in TAGS}
    return out


@pytest.mark.parametrize("case", ["clean", "flagged", "blind"])
def test_ppp_slip_equals_jax(slip_runs, case):
    """The slip case's three runs equal JAX's, solutions and slip counts;
    the reset keeps the flagged run within 0.35 m of the run without the
    slip, while the unflagged slip corrupts the solution by 0.3 m more."""
    assert_same(slip_runs[case]["jax"], slip_runs[case]["port"])
    err = {c: np.linalg.norm(r["port"][0][-1].pos_ecef - RCV)
           for c, r in slip_runs.items()}
    assert slip_runs[case]["port"][1]["n_slips"] == (case == "flagged")
    if case == "flagged":
        assert err["flagged"] < err["clean"] + 0.35
    elif case == "blind":
        assert err["blind"] > err["flagged"] + 0.3


# ------------------------------------------------------------ PPP-AR

T_AR = 353500.0
ZTD = 0.12


@pytest.fixture(scope="module")
def ar_world():
    return _world(T_AR, tgd_zero=True)


def _dual_freq_obs(ephs, prns, t, n1, n2, iono1, rng, pr_sigma=0.3,
                   cp_sigma_m=0.003, bias=None):
    """tests/test_ppp_ar.py's raw dual-frequency observations with their
    iono-free combinations (and a systematic per-satellite code bias)."""
    out = []
    g12 = (F1 / F2) ** 2
    a1 = F1 * F1 / (F1 * F1 - F2 * F2)
    a2 = F2 * F2 / (F1 * F1 - F2 * F2)
    for p in prns:
        eph = ephs[("G", p)]
        o = constellation.simulate_observation(eph, RCV, t,
                                               rcv_clock_bias_s=1e-4)
        az, el = geodesy.az_el(RCV, eph.position_velocity(o.t_tx_sv)[0])
        rho = o.pseudorange_m + ZTD * ppp.tropo_mapping(el)
        i1 = iono1[p]
        p1 = rho + i1 + rng.normal(0, pr_sigma)
        p2 = rho + g12 * i1 + rng.normal(0, pr_sigma)
        l1 = (rho - i1) / LAM1 + n1[p] + rng.normal(0, cp_sigma_m / LAM1)
        l2 = (rho - g12 * i1) / LAM2 + n2[p] + rng.normal(0, cp_sigma_m
                                                          / LAM2)
        o = ppp_ar.PppArObs(
            prn=p, system="G", t_tx_sv=o.t_tx_sv, pr_if_m=a1 * p1 - a2 * p2,
            phase_if_m=a1 * l1 * LAM1 - a2 * l2 * LAM2, p1_m=p1, p2_m=p2,
            l1_cycles=l1, l2_cycles=l2, f1_hz=F1, f2_hz=F2)
        if bias is not None:
            o.p1_m += bias[p]
            o.p2_m += bias[p]
            o.pr_if_m = a1 * o.p1_m - a2 * o.p2_m
        out.append(o)
    return out


def _ar_inputs(ephs, prns, seed, span, n_ep, iono=True, **kw):
    rng = np.random.default_rng(seed)
    n1 = {p: int(rng.integers(-span, span)) for p in prns}
    n2 = {p: int(rng.integers(-span, span)) for p in prns}
    iono1 = {p: float(rng.uniform(1.0, 6.0)) if iono else 0.0 for p in prns}
    bias = ({p: float(rng.uniform(-0.35, 0.35)) for p in prns}
            if kw.pop("with_bias", False) else None)
    epochs = [(_dual_freq_obs(ephs, prns, T_AR + k, n1, n2, iono1, rng,
                              bias=bias, **kw), {}) for k in range(n_ep)]
    return epochs, n1, n2


def test_ppp_ar_fixes_equal_jax(ar_world):
    """tests/test_ppp_ar.py: 250 epochs of dual-frequency observations;
    the same float and fixed solutions, wide-lane integers and ratios as
    JAX's; the wide-lane set equals the truth and the last 30 epochs lie
    within 5 cm."""
    ephs, prns = ar_world
    epochs, n1, n2 = _ar_inputs(ephs, prns, 41, 5_000_000, 250)
    sols, st = _both(_filter_run, "PppArFilter", dict(
        x0_ecef=RCV + np.array([15.0, -8.0, 25.0]), sigma_pr_m=1.05,
        sigma_phase_m=0.012), ephs, epochs)
    assert st["n_fixed_epochs"] > 0
    ref = [p for p in prns if ("G", p) not in st["fixed_wl"]]
    assert len(ref) == 1
    for (_, p), nwl in st["fixed_wl"].items():
        assert nwl == (n1[p] - n2[p]) - (n1[ref[0]] - n2[ref[0]])
    assert np.mean([np.linalg.norm(s.pos_ecef - RCV)
                    for s in sols[220:]]) < 0.05


@pytest.mark.parametrize("cls", ["PppFilter", "PppArFilter"])
def test_ppp_ar_against_float_equals_jax(ar_world, cls):
    """tests/test_ppp_ar.py's float-against-AR case, each filter on the
    same 250 epochs: the same solutions as JAX's; AR ends within 5 cm."""
    ephs, prns = ar_world
    epochs, _, _ = _ar_inputs(ephs, prns, 43, 1000, 250)
    sols, _ = _both(_filter_run, cls, dict(
        x0_ecef=RCV + 20.0, sigma_pr_m=1.05, sigma_phase_m=0.012), ephs,
        epochs)
    if cls == "PppArFilter":
        assert np.linalg.norm(sols[-1].pos_ecef - RCV) < 0.05


def test_ppp_ar_slip_resets_mw_equal_jax(ar_world):
    """A flagged slip on L1 at epoch 30 clears that satellite's
    Melbourne-Wübbena average and wide-lane fix, as in JAX."""
    ephs, prns = ar_world
    rng = np.random.default_rng(47)
    n1 = {p: int(rng.integers(-1000, 1000)) for p in prns}
    n2 = {p: int(rng.integers(-1000, 1000)) for p in prns}
    iono1 = {p: float(rng.uniform(1.0, 6.0)) for p in prns}
    key = ("G", prns[0])
    epochs = []
    for k in range(40):
        obs = _dual_freq_obs(ephs, prns, T_AR + k, n1, n2, iono1, rng)
        if k == 30:
            n1[prns[0]] += 3
        epochs.append((obs, dict(slips={key} if k == 30 else None)))
    _, st = _both(_filter_run, "PppArFilter", dict(
        x0_ecef=RCV, sigma_pr_m=1.05, sigma_phase_m=0.012), ephs, epochs)
    assert st["_mw"][key][0] <= 10


@pytest.fixture(scope="module")
def bias_epochs(ar_world):
    """tests/test_ppp_ar.py's code-bias world: 480 epochs from one
    generator, the blind run taking the first 240 and the gated run the
    next 240, as there."""
    ephs, prns = ar_world
    epochs, _, _ = _ar_inputs(ephs, prns, 41, 2000, 480, iono=False,
                              with_bias=True, cp_sigma_m=0.003)
    return [(obs, dict(dt_s=1.0)) for obs, _ in epochs]


@pytest.mark.parametrize("gate", [0.0, 0.3], ids=["blind", "gated"])
def test_ppp_ar_code_bias_gate_equals_jax(ar_world, bias_epochs, gate):
    """tests/test_ppp_ar.py's systematic per-satellite code bias (up to
    0.35 m on both bands), without and with the gate's bias term: the same
    AR decisions as JAX's; gated, no fix is accepted, the success rate
    stays under 0.9 and the float within 0.8 m."""
    ephs, _ = ar_world
    epochs = bias_epochs[240:] if gate else bias_epochs[:240]
    sols, st = _both(_filter_run, "PppArFilter", dict(
        x0_ecef=np.asarray(RCV) + 15.0, mode="static", estimate_tropo=False,
        sigma_pr_m=0.35, sigma_phase_m=0.004, ratio_threshold=2.5,
        code_bias_m=gate), ephs, epochs)
    if gate:
        assert st["n_fixed_epochs"] == 0 and st["last_success_rate"] < 0.9
        assert np.linalg.norm(np.asarray(sols[-1].pos_ecef) - RCV) < 0.8


# -------------------------------------------------------- PppEngine

def _engine_run(tag, ephs, seed_pos, epochs, windup, kwargs):
    P = _pkg(tag)
    eng = P.engine.PppEngine(twin(ephs, tag), x0_ecef=(0.0, 0.0, 0.0),
                             **kwargs)
    eng.push_epoch(0, [])                  # unseeded: ignored
    unseeded = len(eng.solutions)
    eng.seed_position(seed_pos)
    if windup:
        eng.enable_precise_models(windup=True)
    for k, chans in enumerate(epochs):
        eng.push_epoch(k, twin(chans, tag))
    return dict(unseeded=unseeded, solutions=eng.solutions,
                state=state(eng))


def _chan(p, sig, t_tx, pr, cp, dop):
    return ChannelObservable(prn=p, signal=sig, t_tx_sv=t_tx,
                             pseudorange_m=pr, carrier_phase_cycles=cp,
                             doppler_hz=dop, cn0_dbhz=45.0)


def test_ppp_engine_dual_frequency_equals_jax(ar_world):
    """tests/test_ppp_ar.py's PppEngine: L1 C/A + L5 receiver observables
    (RINEX Doppler sign) for 260 epochs, seeded from a single-point fix;
    the same solutions and AR decisions as JAX's, AR fixed, within 8 cm."""
    ephs, prns = ar_world
    rng = np.random.default_rng(53)
    n1 = {p: int(rng.integers(-1000, 1000)) for p in prns}
    n5 = {p: int(rng.integers(-1000, 1000)) for p in prns}
    iono1 = {p: float(rng.uniform(1.0, 6.0)) for p in prns}
    g15 = (F1 / F5) ** 2
    epochs = []
    for k in range(260):
        t = T_AR + k
        chans = []
        for p in prns:
            eph = ephs[("G", p)]
            o = constellation.simulate_observation(eph, RCV, t,
                                                   rcv_clock_bias_s=1e-4)
            o2 = constellation.simulate_observation(eph, RCV, t + 1.0,
                                                    rcv_clock_bias_s=1e-4)
            rate = o2.pseudorange_m - o.pseudorange_m
            az, el = geodesy.az_el(RCV, eph.position_velocity(o.t_tx_sv)[0])
            rho = o.pseudorange_m + ZTD * ppp.tropo_mapping(el)
            i1 = iono1[p]
            chans.append(_chan(p, "1C", o.t_tx_sv,
                               rho + i1 + rng.normal(0, 0.3),
                               (rho - i1) / LAM1 + n1[p]
                               + rng.normal(0, 0.02), -rate / LAM1))
            chans.append(_chan(p, "L5", o.t_tx_sv,
                               rho + g15 * i1 + rng.normal(0, 0.3),
                               (rho - g15 * i1) / LAM5 + n5[p]
                               + rng.normal(0, 0.02), -rate / LAM5))
        epochs.append(chans)
    got = _both(_engine_run, ephs, RCV + np.array([12.0, -9.0, 20.0]),
                epochs, False, dict(mode="static", sigma_pr_m=1.0,
                                    sigma_phase_m=0.012))
    assert got["unseeded"] == 0 and got["solutions"]
    assert got["state"]["filter"]["n_fixed_epochs"] > 0
    assert np.linalg.norm(got["solutions"][-1].pos_ecef - RCV) < 0.08


@pytest.fixture(scope="module")
def windup_epochs():
    """tests/test_ppp_fidelity.py's dual-frequency (L1 + L5) observables
    carrying the true phase wind-up, 240 epochs of 6 satellites."""
    t0 = 352800.0
    ephs, prns = _world(t0, el_mask=15.0, n=6, tgd_zero=True)
    rng = np.random.default_rng(31)
    n1 = {p: int(rng.integers(-800, 800)) for p in prns}
    n5 = {p: int(rng.integers(-800, 800)) for p in prns}
    windup: dict = {}
    epochs = []
    for k in range(240):
        t = t0 + k
        chans = []
        for p in prns:
            eph = ephs[("G", p)]
            o = constellation.simulate_observation(eph, RCV, t,
                                                   rcv_clock_bias_s=1e-4)
            o2 = constellation.simulate_observation(eph, RCV, t + 1.0,
                                                    rcv_clock_bias_s=1e-4)
            rate = o2.pseudorange_m - o.pseudorange_m
            sat = eph.position_velocity(o.t_tx_sv)[0]
            az, el = geodesy.az_el(RCV, sat)
            rho = o.pseudorange_m + 0.12 * ppp.tropo_mapping(el)
            w = corrections.phase_windup_cycles(
                sat, corrections.sun_position_ecef(t), RCV, TRUE_LLH[0],
                TRUE_LLH[1], prev_cycles=windup.get(p))
            windup[p] = w
            chans.append(_chan(p, "1C", o.t_tx_sv,
                               rho + rng.normal(0, 0.5),
                               rho / LAM1 + n1[p] + w
                               + rng.normal(0, 0.008), -rate / LAM1))
            chans.append(_chan(p, "L5", o.t_tx_sv,
                               rho + rng.normal(0, 0.5),
                               rho / LAM5 + n5[p] + w
                               + rng.normal(0, 0.008), -rate / LAM5))
        epochs.append(chans)
    return ephs, epochs


@pytest.mark.parametrize("windup", [True, False], ids=["corrected",
                                                        "uncorrected"])
def test_ppp_engine_windup_equals_jax(windup_epochs, windup):
    """tests/test_ppp_fidelity.py: PPP-AR on phases that carry the
    satellite's wind-up, with the correction on and off: the same
    solutions and AR decisions as JAX's; corrected, AR fixes within
    5 cm."""
    ephs, epochs = windup_epochs
    got = _both(_engine_run, ephs, RCV + np.array([9.0, -6.0, 14.0]),
                epochs, windup, dict(mode="static", sigma_pr_m=0.8,
                                     sigma_phase_m=0.01))
    if windup:
        assert got["state"]["filter"]["n_fixed_epochs"] > 0
        assert np.linalg.norm(got["solutions"][-1].pos_ecef - RCV) < 0.05


def _bias_run(tag, biases):
    P = _pkg(tag)
    eng = P.engine.PppEngine({}, x0_ecef=(0, 0, 0))
    eng.set_code_biases(twin(biases, tag))
    return [eng._corrected_pr(_chan(p, s, 0.0, 100.0, 0.0, 0.0))
            for p in (3, 5) for s in ("1C", "L5", "1B", "5X", "1G")]


def test_ppp_engine_code_biases_equal_jax():
    """SSR code biases keyed (system, prn) on the engine's pseudoranges
    (tests/test_rtcm.py's cases): GPS L1 / L5 and Galileo E1 biases of
    the same PRN apart, other satellites unchanged."""
    got = _both(_bias_run, [
        rtcm.SsrCodeBias(prn=3, biases={0: 2.0, 14: -1.0}, system="G"),
        rtcm.SsrCodeBias(prn=3, biases={1: -1.5}, system="E")])
    assert got[:3] == [102.0, 99.0, 98.5] and got[5:] == [100.0] * 5
