"""System test of the port: the Galileo E1-B receiver of gnss_sdr_tpu_torch,
on the CPU, from IQ to a position fix, with the battery of
tests/test_e2e_galileo.py: BOC(1,1) VEML tracking of >= 4 satellites, I/NAV
ephemerides (Viterbi + CRC-24Q) against the truth, and a Galileo-only fix
within 2D < 2 m and 3D < 5 m over the last 5 fixes.

The IQ is the JAX package's cached ``e2e_gal_e1`` fixture, loaded with
exactly the key of tests/test_e2e_galileo.py so no new fixture is written.
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


@pytest.fixture(scope="module")
def e2e_run():
    sc = scen.build_galileo_e1_scenario(duration_s=18.0, n_sats=5,
                                        cn0_dbhz=48.0, fs=4.0e6)
    x = fixture_cache.cached_iq(
        "e2e_gal_e1", dict(duration_s=18.0, n_sats=5, cn0_dbhz=48.0,
                           fs=4.0e6, seed=21),
        lambda: sc.generate(seed=21))
    cfg = ReceiverConfig(
        signal="1B", fs=sc.fs, n_channels=5, prns=tuple(sc.prns),
        chunk_ms=100, acq_doppler_max_hz=5000.0, acq_doppler_step_hz=125.0,
        pll_bw_hz=20.0, dll_bw_hz=2.0, pll_bw_narrow_hz=8.0,
        dll_bw_narrow_hz=0.75,
        pvt_apply_tropo=False, pvt_apply_iono=False)
    rx = Receiver(cfg, device="cpu")
    rx.run_source(ArraySignalSource(x, sc.fs))
    return sc, rx


def test_satellites_tracked(e2e_run):
    sc, rx = e2e_run
    assert len(set(rx.tracked_prns()) & set(sc.prns)) >= 4
    # one signal group: the E1 loop of 27 steps per 100 ms chunk
    g, = rx.groups
    assert (g.trk_cfg.n_steps, g.trk_cfg.n_max, g.trk_cfg.table_rate) == \
        (27, 16064, 2)
    assert rx.scan_steps == 27 * rx.tracking_dispatches > 0


def test_inav_ephemeris_decoded(e2e_run):
    sc, rx = e2e_run
    assert len(rx.ephemerides) >= 4
    for (system, prn), eph in rx.ephemerides.items():
        true = sc.ephemerides[prn]
        assert system == "E"
        assert abs(eph.sqrt_a - true.sqrt_a) <= 2.0 ** -19
        assert eph.toe == true.toe
        assert eph.gm == pytest.approx(3.986004418e14)


def test_galileo_position_fix(e2e_run):
    sc, rx = e2e_run
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
