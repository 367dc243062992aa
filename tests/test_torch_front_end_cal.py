"""The port's front-end calibration (gnss_sdr_tpu_torch.utils.front_end_cal)
against the JAX package's, on the CPU.

The capture of the JAX test ``test_full_cal_flow_from_capture``: five
visible satellites at 46 dB-Hz whose front-end oscillator is 3 ppm off
(~4.7 kHz at L1), 80 ms at 2 MSps. The all-PRN sweep runs through both
packages' PCPS: every row's detection flag, Doppler and code phase equal,
and the CFAR statistic within rtol 1e-4. The fitted offset recovers the
3 ppm within that test's bounds (200 Hz, 0.15 ppm) and equals JAX's fit.
The oscillator fit alone matches JAX bit for bit.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.utils import front_end_cal as jcal
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.utils import constellation, generator
from gnss_sdr_tpu_torch.utils import front_end_cal as tcal

torch.set_num_threads(1)   # one thread per xdist worker

F_L1 = 1.57542e9
T_GPS = 354000.0


def _sky():
    ephs = constellation.almanac_constellation()
    rcv = geodesy.geodetic_to_ecef(np.deg2rad(41.275), np.deg2rad(1.9876),
                                   80.0)
    return ephs, rcv


def _jax_ephs(ephs):
    from gnss_sdr_tpu.models.ephemeris import KeplerEphemeris
    return {p: KeplerEphemeris(**{f: getattr(e, f) for f in
                                  e.__dataclass_fields__})
            for p, e in ephs.items()}


def test_oscillator_fit_matches_jax():
    ephs, rcv = _sky()
    vis = constellation.visible_sats(ephs, rcv, T_GPS)[:6]
    rng = np.random.default_rng(0)
    measured = {p: constellation.simulate_observation(ephs[p], rcv,
                                                      T_GPS).doppler_hz
                + 3.2e-6 * F_L1 + rng.normal(0, 5.0) for p, _, _ in vis}
    got = tcal.estimate_oscillator_error(measured, ephs, rcv, T_GPS, F_L1)
    want = jcal.estimate_oscillator_error(measured, _jax_ephs(ephs), rcv,
                                          T_GPS, F_L1)
    assert got.n_sats == want.n_sats == 6
    assert got.clock_offset_hz == want.clock_offset_hz
    assert got.residuals_hz == want.residuals_hz
    assert abs(got.clock_offset_ppm - 3.2) < 0.1
    with pytest.raises(ValueError, match="no overlapping PRNs"):
        tcal.estimate_oscillator_error({40: 0.0}, ephs, rcv, T_GPS)


def test_full_cal_flow_matches_jax():
    ephs, rcv = _sky()
    vis = constellation.visible_sats(ephs, rcv, T_GPS)[:5]
    osc_hz = 3.0e-6 * F_L1
    fs = 2.0e6
    sats = [generator.SatParams(
        prn=p, cn0_dbhz=46.0, code_delay_s=1.7e-4 * k,
        doppler_hz=constellation.simulate_observation(
            ephs[p], rcv, T_GPS).doppler_hz + osc_hz)
        for k, (p, _, _) in enumerate(vis)]
    x = generator.generate(constants.SIGNALS["1C"], sats, fs, 0.08, seed=3)

    cal, rows = tcal.run_front_end_cal(x, fs, ephs, rcv, T_GPS,
                                       doppler_max_hz=10_000.0,
                                       doppler_step_hz=250.0, device="cpu")
    jcal_res, jrows = jcal.run_front_end_cal(x, fs, _jax_ephs(ephs), rcv,
                                             T_GPS, doppler_max_hz=10_000.0,
                                             doppler_step_hz=250.0)
    assert [r.prn for r in rows] == list(range(1, 33))
    for r, j in zip(rows, jrows):
        assert (r.prn, r.detected, r.doppler_hz, r.code_phase) == \
            (j.prn, j.detected, j.doppler_hz, j.code_phase), r.prn
        assert r.test_cfar == pytest.approx(j.test_cfar, rel=1e-4)
    det = {r.prn for r in rows if r.detected}
    assert {p for p, _, _ in vis} <= det and len(det) <= len(vis) + 3
    assert cal.n_sats >= 5 and cal.n_sats == jcal_res.n_sats
    assert abs(cal.clock_offset_hz - osc_hz) < 200.0
    assert abs(cal.clock_offset_ppm - 3.0) < 0.15
    assert cal.clock_offset_hz == jcal_res.clock_offset_hz
    # the ("G", prn) keys of an assistance record select the same fit
    cal_g, _ = tcal.run_front_end_cal(
        x, fs, {("G", p): e for p, e in ephs.items()}, rcv,
        T_GPS, device="cpu")
    assert cal_g.clock_offset_hz == cal.clock_offset_hz
