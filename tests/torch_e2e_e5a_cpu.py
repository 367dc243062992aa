"""System test of the port: the Galileo E5a receiver of gnss_sdr_tpu_torch,
on the CPU, from IQ to a position fix, with the battery of
tests/test_e2e_e5a.py: 10.23 Mcps tracking at 12 MSps with the CS20
overlay, F/NAV pages, PCPS acquisition at 125 Hz bins, all 4 satellites
tracked, >= 4 ephemerides against the truth and an E5a-only fix within
2D < 2 m and 3D < 5 m over the last 5 fixes.

The IQ is the JAX package's cached ``e2e_gal_e5a`` fixture, loaded with
exactly the key of tests/test_e2e_e5a.py so no new fixture is written.

The file is not named ``test_*.py``, so ``pytest tests/`` does not collect
it: on one thread it takes longer than the test suite's budget allows one
file. Run it by name, ``-s`` to see the host seconds of each receiver
stage::

    python -m pytest tests/torch_e2e_e5a_cpu.py -q -s -p no:cacheprovider
"""

import time

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.utils import fixture_cache, scenario as scen
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

torch.set_num_threads(1)   # one thread, as in the suite's port tests

FS = 12.0e6


@pytest.fixture(scope="module")
def e5a_run():
    sc = scen.build_galileo_e5a_scenario(fs=FS, n_sats=4, cn0_dbhz=50.0)
    x = fixture_cache.cached_iq(
        "e2e_gal_e5a", dict(duration_s=round(sc.duration_s, 3), n_sats=4,
                            cn0_dbhz=50.0, fs=FS, seed=87),
        lambda: sc.generate(seed=87))
    cfg = ReceiverConfig(
        signal="5X", fs=FS, n_channels=4, prns=tuple(sc.prns),
        chunk_ms=100, acq_doppler_max_hz=5000.0, acq_doppler_step_hz=125.0,
        pll_bw_hz=25.0, dll_bw_hz=2.0,
        pvt_apply_tropo=False, pvt_apply_iono=False)
    rx = Receiver(cfg, device="cpu")
    spent = _timed(rx, ("_upload", "_run_acquisition", "_dispatch_tracking",
                        "_finish_tracking", "_consume_tracking",
                        "_run_observables"))
    t0 = time.perf_counter()
    rx.run_source(ArraySignalSource(x, FS))
    wall = time.perf_counter() - t0
    print("\ne5a cpu receiver wall_s=%.3f " % wall + " ".join(
        f"{k}_s={v:.3f}" for k, v in spent.items()))
    return sc, rx


def _timed(rx, names):
    """Host seconds spent in each named receiver method, accumulated by an
    instance attribute that shadows the method."""
    acc = {}
    for name in names:
        fn = getattr(rx, name)
        acc[name] = 0.0

        def wrapper(*a, _fn=fn, _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc[_name] += time.perf_counter() - t
        setattr(rx, name, wrapper)
    return acc


def test_e5a_satellites_tracked(e5a_run):
    sc, rx = e5a_run
    assert sorted(rx.tracked_prns()) == sorted(sc.prns)
    g, = rx.groups
    assert (g.trk_cfg.n_steps, g.trk_cfg.n_max, g.trk_cfg.table_rate) == \
        (102, 12064, 1)
    _, obs = rx.obs_log[-1]
    assert {o.carrier_freq_hz for o in obs} == {1_176_450_000.0}


def test_e5a_fnav_ephemerides(e5a_run):
    sc, rx = e5a_run
    assert len(rx.ephemerides) >= 4
    for (system, prn), eph in rx.ephemerides.items():
        assert system == "E"
        true = sc.ephemerides[prn]
        assert abs(eph.sqrt_a - true.sqrt_a) < 1e-4
        assert eph.toe == true.toe


def test_e5a_position_fix(e5a_run):
    sc, rx = e5a_run
    assert len(rx.fixes) >= 3, f"only {len(rx.fixes)} fixes"
    lat, lon, _ = sc.rcv_llh
    errs_enu = np.stack([
        geodesy.ecef_to_enu(f.pos_ecef - sc.rcv_ecef, lat, lon)
        for f in rx.fixes[-5:]])
    mean_enu = errs_enu.mean(axis=0)
    err_2d = np.hypot(mean_enu[0], mean_enu[1])
    err_3d = np.linalg.norm(mean_enu)
    assert err_2d < 2.0, f"2D error {err_2d:.2f} m"
    assert err_3d < 5.0, f"3D error {err_3d:.2f} m"
