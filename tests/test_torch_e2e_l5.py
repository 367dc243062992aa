"""System test of the port: the GPS L5I receiver of gnss_sdr_tpu_torch, on
the CPU, from IQ to a position fix, with the battery of
tests/test_e2e_l5.py: 10.23 Mcps tracking at 11 MSps (100 steps per 100 ms
chunk, 10,230-entry tables), NH10 symbol sync, 100 sps CNAV telemetry (K=7
Viterbi + CRC-24Q), all 4 satellites tracked, >= 4 ephemerides against the
truth and an L5-only fix within 2D < 2 m and 3D < 5 m over the last 5
fixes.

The IQ is the JAX package's cached ``e2e_gps_l5`` fixture, loaded with
exactly the key of tests/test_e2e_l5.py so no new fixture is written.
Three tests, for the ``--dist loadfile`` queueing reason given in
tests/test_torch_e2e.py.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.utils import fixture_cache, scenario as scen
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

torch.set_num_threads(1)   # one thread per xdist worker

DUR = 30.0
FS = 11.0e6


@pytest.fixture(scope="module")
def l5_run():
    sc = scen.build_gps_l5_scenario(duration_s=DUR, n_sats=4, cn0_dbhz=50.0,
                                    fs=FS)
    x = fixture_cache.cached_iq(
        "e2e_gps_l5", dict(duration_s=DUR, n_sats=4, cn0_dbhz=50.0,
                           fs=FS, seed=77),
        lambda: sc.generate(seed=77))
    cfg = ReceiverConfig(
        signal="L5", fs=FS, n_channels=4, prns=tuple(sc.prns),
        chunk_ms=100, acq_doppler_max_hz=5000.0, acq_doppler_step_hz=250.0,
        pvt_apply_tropo=False, pvt_apply_iono=False)
    rx = Receiver(cfg, device="cpu")
    rx.run_source(ArraySignalSource(x, FS))
    return sc, rx


def test_l5_satellites_tracked(l5_run):
    sc, rx = l5_run
    assert sorted(rx.tracked_prns()) == sorted(sc.prns)
    g, = rx.groups
    assert (g.trk_cfg.n_steps, g.trk_cfg.n_max, g.trk_cfg.table_rate) == \
        (102, 11064, 1)
    assert rx.scan_steps == 102 * rx.tracking_dispatches > 0
    # the carrier phase is counted in L5 wavelengths, not L1's (the JAX
    # observables default to 1575.42 MHz when no carrier is passed)
    _, obs = rx.obs_log[-1]
    assert {o.carrier_freq_hz for o in obs} == {1_176_450_000.0}


def test_l5_cnav_ephemerides(l5_run):
    sc, rx = l5_run
    assert len(rx.ephemerides) >= 4
    for (system, prn), eph in rx.ephemerides.items():
        assert system == "G"
        true = sc.ephemerides[prn]
        assert abs(eph.sqrt_a - true.sqrt_a) < 1e-4
        assert eph.toe == true.toe


def test_l5_position_fix(l5_run):
    sc, rx = l5_run
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
