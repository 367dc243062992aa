"""Quick checks of the port's receiver (gnss_sdr_tpu_torch.receiver) on the
CPU: the scenario copy against the JAX package's, the fields and devices it
refuses, and one acquisition pass against the JAX receiver's on the same
int8 upload. The first 3 s of tests/test_pipeline.py's cached ``kdisp``
fixture (same key, no new bytes) are the signal.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.utils import fixture_cache, scenario as scen
from gnss_sdr_tpu_torch.ops import acquisition as acq_ops
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.utils import scenario as tscen

torch.set_num_threads(1)   # one thread per xdist worker


def test_port_scenario_matches_reference():
    """The port's scenario copy builds the same satellites and truth."""
    a = scen.build_gps_l1_scenario(duration_s=28.0, n_sats=6, cn0_dbhz=47.0,
                                   fs=2.0e6)
    b = tscen.build_gps_l1_scenario(duration_s=28.0, n_sats=6, cn0_dbhz=47.0,
                                    fs=2.0e6)
    assert a.prns == b.prns
    np.testing.assert_array_equal(a.rcv_ecef, b.rcv_ecef)
    for sa, sb in zip(a.sats, b.sats):
        assert (sa.prn, sa.doppler_hz, sa.code_delay_s,
                sa.carrier_phase_cycles) == (sb.prn, sb.doppler_hz,
                                             sb.code_delay_s,
                                             sb.carrier_phase_cycles)
        np.testing.assert_array_equal(sa.data_bits, sb.data_bits)


def test_receiver_refuses_unported_fields(tmp_path):
    """Every signal of the JAX package is ported: GLONASS alone and in a
    plan with GPS L1 builds, a GLONASS group at its slots; so are the
    Kalman carrier loop, the TCP-connector tracking, the E1 8 ms
    acquisition and the dumps; only channels sharded over several devices
    raise, naming the field."""
    rx = Receiver(ReceiverConfig(signal="1G", fs=8e6), device="cpu")
    assert rx.groups[0].if_freq_for(10) == -7 * 562500.0
    rx = Receiver(ReceiverConfig(fs=8e6, signal_plan=(("1C", 4), ("1G", 4))),
                  device="cpu")
    assert [g.signal for g in rx.groups] == ["1C", "1G"]
    assert rx.groups[0].if_freq_for(10) == 0.0
    rx = Receiver(ReceiverConfig(fs=2e6, carrier_kf=True), device="cpu")
    assert rx.groups[0].trk_cfg.carrier_kf
    for field, value in [("tcp_connector", True), ("acq_variant", "e1_8ms"),
                         ("dump_dir", str(tmp_path))]:
        rx = Receiver(ReceiverConfig(signal="1B" if value == "e1_8ms"
                                     else "1C", fs=4e6, tcp_port_ch0=0,
                                     **{field: value}), device="cpu")
        assert getattr(rx.cfg, field) == value
        rx.close()
    with pytest.raises(NotImplementedError, match="n_mesh_devices"):
        Receiver(ReceiverConfig(n_mesh_devices=8), device="cpu")


def test_receiver_default_device_needs_a_card():
    if torch.cuda.is_available():
        assert Receiver(ReceiverConfig(fs=2e6)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Receiver(ReceiverConfig(fs=2e6))


@pytest.fixture(scope="module")
def kdisp_iq():
    # the cached fixture of tests/test_pipeline.py (same key, no new bytes);
    # its first 3 s are enough for acquisition and steady tracking
    sc = scen.build_gps_l1_scenario(duration_s=6.0, n_sats=4, cn0_dbhz=48.0,
                                    fs=2.0e6)
    x = fixture_cache.cached_iq(
        "kdisp", dict(dur=6.0, n=4, fs=2.0e6, seed=11),
        lambda: sc.generate(seed=11))
    return sc, x[: int(3.0 * sc.fs)]


@pytest.mark.parametrize("assisted", [False, True])
def test_acquisition_assigns_like_jax(kdisp_iq, assisted, monkeypatch):
    """One acquisition pass of the receiver on the first chunk, default
    grid or assisted per-satellite grids (Doppler hints 40 Hz off the
    truth), assigns the same satellites to the same channels at the same
    code delay and Doppler as the JAX receiver on the same int8 upload; a
    PRN absent from the signal stays unassigned in both."""
    import jax
    from gnss_sdr_tpu.ops import iq as jiq
    from gnss_sdr_tpu.receiver import receiver as jrx

    sc, x = kdisp_iq
    pool = tuple(sc.prns) + (31,)
    kw = dict(signal="1C", fs=sc.fs, n_channels=4, prns=pool, chunk_ms=100,
              pvt_apply_tropo=False, pvt_apply_iono=False)
    a = Receiver(ReceiverConfig(**kw), device="cpu")
    b = jrx.Receiver(jrx.ReceiverConfig(**kw))
    chunk = x[: a.chunk_len + a.n_max]
    if assisted:
        truth = {s.prn: s.doppler_hz for s in sc.sats}
        hints = {("G", p): {"doppler_hz": truth.get(p, 0.0) + 40.0,
                            "tow_s": None} for p in pool}
        a.acq_assist, b.acq_assist = dict(hints), dict(hints)
    grids = []
    search = acq_ops.pcps_search_grids
    monkeypatch.setattr(acq_ops, "pcps_search_grids",
                        lambda *a, **k: grids.append(1) or search(*a, **k))
    a._run_acquisition(a.groups[0], chunk, a._upload(chunk))
    assert len(grids) == int(assisted)
    b._run_acquisition(b.groups[0], chunk, jax.device_put(
        jiq.quantize8(chunk, rms=jiq.measure_rms(chunk))))
    assert [c.prn for c in a.groups[0].channels] == \
        [c.prn for c in b.groups[0].channels]
    assert sorted(c.prn for c in a.groups[0].channels) == sorted(sc.prns)
    ta = a.groups[0].trk_state
    tb = b.groups[0].trk_state
    np.testing.assert_array_equal(ta.sample_offset.numpy(),
                                  np.asarray(tb.sample_offset))
    for f in ("carrier_freq", "code_freq"):
        np.testing.assert_allclose(getattr(ta, f).numpy(),
                                   np.asarray(getattr(tb, f)), rtol=1e-6,
                                   err_msg=f)


def test_upload_counts_and_logs_the_4bit_clip_rate(caplog):
    """At upload_bits=4 the receiver counts the I / Q components the nibble
    quantizer clips, logs them per upload (debug) and, when the scale is set
    again after JAX's ~50 chunks, the rate since it was last set (info); the
    scale's refresh policy is JAX's. A constructed chunk: unit-rms noise
    with 37 components pushed far past the 4-bit range. Each upload stage's
    host seconds add up."""
    from gnss_sdr_tpu_torch.ops import iq

    rx = Receiver(ReceiverConfig(fs=2.0e6, upload_bits=4), device="cpu")
    n = rx.chunk_len + rx.n_max
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * np.float32(np.sqrt(0.5))
    spikes = rng.choice(2 * n, 37, replace=False)
    flat = x.view(np.float32)
    flat[spikes] = np.where(spikes % 3 == 0, -50.0, 50.0)
    rms = iq.measure_rms(x)
    s = np.float32(iq.QUANT4_RMS / rms)
    q = np.rint(flat * s)                  # the nibble holds -8 .. 7
    want = int(np.count_nonzero((q < -8) | (q > 7)))
    assert want >= 37
    with caplog.at_level("DEBUG", logger="gnss_sdr_tpu_torch"):
        out = rx._upload(x)
        assert out.shape == (n, 2) and out.dtype == torch.float32
        assert (rx.upload_clipped, rx.upload_components) == (want, 2 * n)
        assert f"{want} of {2 * n} I/Q components clipped" in caplog.text
        rx._upload(x)                          # same scale: counts add up
        assert rx.upload_clipped == 2 * want
        rx._chunk_index = rx._q_rms_next       # JAX's refresh is due
        rx._upload(x)
    assert (f"{2 * want} of {4 * n} I/Q components "
            f"({100.0 * want / (2 * n):.4f} %) clipped") in caplog.text
    assert rx.upload_clipped == want           # counted from the new scale
    assert all(v > 0.0 for v in rx.upload_seconds.values())
