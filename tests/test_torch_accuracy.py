"""The port's accuracy statistics (gnss_sdr_tpu_torch.utils.accuracy) and
RAIM (``receiver.pvt.solver.solve_pvt_fde``) against the JAX package's, on
the CPU: both are numpy copies, held bit for bit on the same seeded inputs.

tests/test_accuracy.py's Gaussian and bias cases through both packages:
every statistic equal, the formatted block equal. tests/test_pvt.py:200-
235's fault case (a 60 m fault on one of 8 satellites): the same excluded
PRN, the position within 1e-6 m of JAX's (bit for bit in fact), and JAX's
budgets; the clean set passes with no exclusion.
"""

import numpy as np
import pytest

from gnss_sdr_tpu.receiver.pvt import geodesy as jgeo
from gnss_sdr_tpu.receiver.pvt import solver as jsolver
from gnss_sdr_tpu.utils import accuracy as jacc
from gnss_sdr_tpu.utils import constellation as jconst
from gnss_sdr_tpu_torch.receiver.pvt import solver as tsolver
from gnss_sdr_tpu_torch.utils import accuracy as tacc
from torch_twin import twin

TRUE_LLH = (np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
T_RX = 354000.0


@pytest.mark.parametrize("case", ["gaussian", "bias"])
def test_statistics_match_jax(case):
    if case == "gaussian":
        rng = np.random.default_rng(42)
        enu = rng.standard_normal((200000, 3)) * [1.0, 1.5, 3.0]
    else:
        enu = np.tile([3.0, 4.0, 0.0], (10, 1))
    want, got = jacc.position_statistics(enu), tacc.position_statistics(enu)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (tacc.format_statistics(got, "static")
            == jacc.format_statistics(want, "static"))
    if case == "gaussian":
        assert got["drms"] == pytest.approx(np.hypot(1.0, 1.5), rel=0.02)
        assert got["cep"] == pytest.approx(0.5887 * 2.5, rel=0.03)
    else:
        assert got["drms"] == pytest.approx(5.0)
        assert "DRMS 5.000" in tacc.format_statistics(got, "static")
    for mod in (jacc, tacc):
        with pytest.raises(ValueError):
            mod.position_statistics(np.zeros((4, 2)))


@pytest.fixture(scope="module")
def world():
    ephs = jconst.almanac_constellation()
    rcv = jgeo.geodetic_to_ecef(*TRUE_LLH)
    vis = jconst.visible_sats(ephs, rcv, T_RX, el_mask_deg=10.0)
    return ephs, rcv, vis


def _solve_both(obs, ephs, **kw):
    want = jsolver.solve_pvt_fde(obs, ephs, **kw)
    got = tsolver.solve_pvt_fde(twin(obs, "port"), twin(ephs, "port"), **kw)
    return want, got


def test_raim_excludes_faulty_satellite(world):
    ephs, rcv, vis = world
    rng = np.random.default_rng(9)
    obs = []
    for prn, _, _ in vis[:8]:
        o = jconst.simulate_observation(ephs[prn], rcv, T_RX)
        o.pseudorange_m += rng.normal(0, 1.0)
        obs.append(o)
    bad_prn = obs[2].prn
    obs[2].pseudorange_m += 60.0
    want, got = _solve_both(obs, ephs, sigma_pr_m=1.5, iono=None,
                            apply_tropo=False)
    assert got.valid and want.valid
    assert got.excluded_prn == want.excluded_prn == ("G", bad_prn)
    assert np.max(np.abs(got.pos_ecef - want.pos_ecef)) < 1e-6
    plain = tsolver.solve_pvt(twin(obs, "port"), twin(ephs, "port"),
                              iono=None, apply_tropo=False)
    err = np.linalg.norm(got.pos_ecef - rcv)
    assert err < np.linalg.norm(plain.pos_ecef - rcv) and err < 5.0


def test_raim_passes_clean_set(world):
    ephs, rcv, vis = world
    obs = [jconst.simulate_observation(ephs[prn], rcv, T_RX)
           for prn, _, _ in vis[:8]]
    want, got = _solve_both(obs, ephs, iono=None, apply_tropo=False)
    assert got.valid and got.excluded_prn is None is want.excluded_prn
    assert np.max(np.abs(got.pos_ecef - want.pos_ecef)) < 1e-6
    assert np.linalg.norm(got.pos_ecef - rcv) < 0.05
