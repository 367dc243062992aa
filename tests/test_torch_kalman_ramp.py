"""The ``carrier_kf`` branch of the port's eager tracking step against the
JAX package, on tests/test_tracking.py's Doppler-ramp case (PRN 5, -300
Hz, 60 Hz/s, 1.5 s at 2.5 MSps, one channel) through JAX's
``track_chunk`` and the port's eager loop: the integer fields equal at
every step; the float fields within rtol 1e-4 / atol 1e-4 and the
correlator sums within |dz| <= 1e-4 |z| + 1e-4
(tests/test_torch_tracking.py's bounds); and the port meets that test's
own asserts. The floats are not JAX's bits: the sums' block order, as on
every tracking test, and the C/N0 estimate that sets the KF's measurement
variance, whose log10 the port takes with the C library's (XLA's CPU
backend has a log of its own, off the C library's on ~0.7 % of inputs).
Fed JAX's sums, the port's carrier frequency keeps JAX's bits through
pull-in and leaves them at the 15th KF update (step 116), where the two
C/N0 estimates first differ. Also: the packed CPU dispatch with
``carrier_kf`` equals the unpacked one, and a receiver with ``carrier_kf``
tracks the ramp's first 0.6 s with the KF. The filter's functions alone:
tests/test_torch_kalman.py (three tests a file: see there).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gnss_sdr_tpu import constants as jc
from gnss_sdr_tpu.receiver import tracking as jtrk
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
from gnss_sdr_tpu_torch.models import codes
from gnss_sdr_tpu_torch.ops import kalman as tk
from gnss_sdr_tpu_torch.ops import tracking_kernel
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.utils import generator

torch.set_num_threads(1)   # one thread per xdist worker

FS = 2.5e6
FD0, RATE, DELAY_S, DUR = -300.0, 60.0, 0.00025, 1.5
EPS = 1e-4


@pytest.fixture(scope="module")
def ramp():
    """The ramp case's samples, configs and start carry."""
    spec = constants.GPS_L1_CA
    x = generator.generate(
        spec, [generator.SatParams(prn=5, cn0_dbhz=44.0, doppler_hz=FD0,
                                   doppler_rate_hz_s=RATE,
                                   code_delay_s=DELAY_S)], FS, DUR, seed=41)
    jcfg = jtrk.default_config(jc.GPS_L1_CA, FS, chunk_ms=50,
                               carrier_kf=True, stride_plan=None)
    tcfg = ttrk.TrackingConfig.from_fields(dataclasses.asdict(jcfg))
    assert tcfg == ttrk.default_config(spec, FS, 50, carrier_kf=True)
    state = jtrk.start_channel(
        jtrk.init_state(1, jcfg.n_taps), 0,
        code_freq=1.023e6 * (1 + FD0 / spec.carrier_freq_hz),
        doppler_hz=FD0 + 30.0, sample_offset=int(round(DELAY_S * FS)))
    return dict(x=np.stack([x.real, x.imag], -1).astype(np.float32),
                xc=x, jcfg=jcfg, tcfg=tcfg, state=state,
                table=codes.code_chips("1C", 5)[None].astype(np.float32),
                n_chunks=int((len(x) - jcfg.n_max) // jcfg.chunk_len))


def test_ramp_against_jax(ramp):
    jcfg, tcfg, x = ramp["jcfg"], ramp["tcfg"], ramp["x"]
    jst, tst = ramp["state"], ttrk.state_from_numpy(ramp["state"], "cpu")
    table = ramp["table"]
    jouts, touts = [], []
    for k in range(ramp["n_chunks"]):
        part = x[k * jcfg.chunk_len: k * jcfg.chunk_len + jcfg.chunk_len
                 + jcfg.n_max]
        jst, jo = jtrk.track_chunk(jcfg, jnp.asarray(part), jst,
                                   jnp.asarray(table))
        tst, to = ttrk.track_chunk(tcfg, torch.from_numpy(part), tst,
                                   torch.from_numpy(table))
        jouts.append(jo)
        touts.append(to)

    def cat(outs, f):
        return np.concatenate([np.asarray(getattr(o, f)) for o in outs])

    for f in ("valid", "state", "n_samples", "start_offset", "epoch_index",
              "carr_phase_cycles"):
        bad = np.argwhere(cat(jouts, f) != cat(touts, f))
        assert not len(bad), f"{f}: first (step, channel) {bad[:3]}"
    for f in ("rem_code_phase", "code_freq", "carrier_freq",
              "carr_phase_frac", "cn0_dbhz", "carrier_lock"):
        np.testing.assert_allclose(cat(touts, f), cat(jouts, f), rtol=EPS,
                                   atol=EPS, err_msg=f)
    for f in ("prompt", "correlators"):
        a, b = cat(jouts, f), cat(touts, f)
        za, zb = a[..., 0] + 1j * a[..., 1], b[..., 0] + 1j * b[..., 1]
        assert (np.abs(zb - za) <= EPS * np.abs(za) + EPS).all(), f
    # the KF ran: the rate state and covariance left their start values
    st = ttrk.state_to_numpy(tst)
    for name in ("kf_acc", "carrier_freq", "carr_phase_frac"):
        np.testing.assert_allclose(getattr(st, name),
                                   np.asarray(getattr(jst, name)),
                                   rtol=EPS, atol=EPS, err_msg=name)
    np.testing.assert_allclose(st.kf_p, np.asarray(jst.kf_p), rtol=EPS,
                               atol=EPS)
    # tests/test_tracking.py's own asserts, on the port's loop
    assert not bool(st.loss_of_lock[0])
    fd_final = FD0 + RATE * (int(st.epoch_count[0]) * 1e-3)
    assert abs(float(st.carrier_freq[0]) - fd_final) < 5.0
    assert abs(float(st.kf_acc[0]) - RATE) < 20.0
    v = touts[-1].valid[:, 0].numpy()
    assert float(touts[-1].carrier_lock[:, 0].numpy()[v][-1]) > 0.85


def test_packed_cpu_dispatch_with_kf(ramp):
    """track_chunk_packed on the packed carry gives the unpacked dispatch's
    rows and carry, kf_p and kf_acc included, over four 50 ms chunks (the
    KF updates from epoch ~100)."""
    cfg, x = ramp["tcfg"], ramp["x"]
    table = torch.from_numpy(ramp["table"])
    st = ttrk.state_from_numpy(ramp["state"], "cpu")
    buf = tracking_kernel.pack_carry(st)
    for k in range(4):
        part = torch.from_numpy(x[k * cfg.chunk_len: (k + 1) * cfg.chunk_len
                                  + cfg.n_max])
        st, rows = ttrk.track_chunk_packed(cfg, part, st, table)
        buf, rows_b = ttrk.track_chunk_packed(cfg, part, buf, table)
        assert torch.equal(rows_b.view(torch.int32), rows.view(torch.int32))
        assert torch.equal(buf, tracking_kernel.pack_carry(st))
    assert float(st.kf_acc[0]) != 0.0
    assert not torch.equal(st.kf_p, torch.from_numpy(tk.kf_init_cov(1)))


def test_receiver_with_carrier_kf_tracks_the_ramp(ramp):
    """ReceiverConfig(carrier_kf=True) builds a KF tracking group and
    runs: on the ramp's first 0.6 s the satellite is acquired, leaves
    pull-in and is tracked by the KF (its covariance and rate state leave
    their start values). The ramp over 1.5 s through the receiver's KF
    runs on the card (chip_smoke.py's kf phase)."""
    rx = Receiver(ReceiverConfig(signal="1C", fs=FS, n_channels=1,
                                 prns=(5,), chunk_ms=50, carrier_kf=True,
                                 pvt_enabled=False), device="cpu")
    assert rx.groups[0].trk_cfg.carrier_kf
    rx.run_source(ArraySignalSource(ramp["xc"][: int(0.6 * FS)], FS))
    assert rx.tracked_prns() == [5]
    st = ttrk.state_to_numpy(rx.groups[0].trk_state)
    assert int(st.state[0]) >= ttrk.WIDE_TRACK
    assert float(st.kf_acc[0]) != 0.0
    assert not np.array_equal(st.kf_p[0], tk.kf_init_cov(1)[0])
