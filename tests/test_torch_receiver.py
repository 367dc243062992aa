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


def test_receiver_refuses_unported_fields():
    for field, value in [("signal", "5X"), ("carrier_kf", True),
                         ("tcp_connector", True),
                         ("acq_variant", "e1_8ms"), ("dump_dir", "x"),
                         ("n_mesh_devices", 8),
                         ("signal_plan", (("1C", 4), ("L5", 4)))]:
        with pytest.raises(NotImplementedError, match=field):
            Receiver(ReceiverConfig(**{field: value}), device="cpu")


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
