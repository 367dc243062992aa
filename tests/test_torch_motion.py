"""Receiver motion in the port's GPS L1 scenario against the JAX package's
scenario function, on the CPU: ``build_gps_l1_scenario(vel_enu=...)``
(the dynamic system test's constant-velocity receiver,
tests/test_e2e_dynamic.py) gives
the same truth trajectory (``rcv_vel_ecef``, ``rcv_pos_at``) and the same
satellite parameters (every ``SatParams`` field: the cubic fits of the
transmit time along the moving receiver's path) to float64 round-off
(rtol 1e-12, the two fits run the same numpy calls), and ``generate`` of a
0.2 s moving scenario equals JAX's within atol 1e-6 (the port sums the
carrier in float32 after a float64 mod-1 reduction, as JAX's generator
does). A static scenario keeps ``rcv_vel_ecef`` None in both.

The dynamic budgets themselves (3D RMSE < 10 m and < 5 m/s on the cached
``e2e_dynamic`` capture's scenario) are held on the card by chip_smoke.py's
``dynamic`` phase.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.utils import scenario as jscen
from gnss_sdr_tpu_torch.utils import scenario as tscen

torch.set_num_threads(1)   # one thread per xdist worker

VEL_ENU = (12.0, -5.0, 0.0)     # tests/test_e2e_dynamic.py


def _same_sats(a, b):
    assert a.prns == b.prns
    for sa, sb in zip(a.sats, b.sats):
        da, db = dataclasses.asdict(sa), dataclasses.asdict(sb)
        assert da.keys() == db.keys()
        for k in da:
            if da[k] is None:
                assert db[k] is None, k
            else:
                np.testing.assert_allclose(np.asarray(db[k], np.float64),
                                           np.asarray(da[k], np.float64),
                                           rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("vel_enu", [VEL_ENU, (0.0, 0.0, 0.0)],
                         ids=["moving", "static"])
def test_moving_scenario_equal_jax(vel_enu):
    kw = dict(duration_s=28.0, n_sats=6, cn0_dbhz=47.0, fs=2.0e6,
              vel_enu=vel_enu)
    j, t = jscen.build_gps_l1_scenario(**kw), tscen.build_gps_l1_scenario(**kw)
    _same_sats(j, t)
    np.testing.assert_array_equal(t.rcv_ecef, j.rcv_ecef)
    if vel_enu == VEL_ENU:
        np.testing.assert_allclose(t.rcv_vel_ecef, j.rcv_vel_ecef,
                                   rtol=1e-12, atol=1e-12)
        assert np.linalg.norm(t.rcv_vel_ecef) == pytest.approx(13.0)
    else:
        assert t.rcv_vel_ecef is None and j.rcv_vel_ecef is None
    for dt in (0.0, 1.5, 27.9):
        np.testing.assert_allclose(t.rcv_pos_at(dt), j.rcv_pos_at(dt),
                                   rtol=1e-12, atol=1e-6)


def test_moving_scenario_generate_equal_jax():
    kw = dict(duration_s=0.2, n_sats=6, cn0_dbhz=47.0, fs=2.0e6,
              vel_enu=VEL_ENU)
    j, t = jscen.build_gps_l1_scenario(**kw), tscen.build_gps_l1_scenario(**kw)
    xj, xt = j.generate(seed=41), t.generate(seed=41)
    assert xt.shape == xj.shape == (400000,) and xt.dtype == np.complex64
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6)
