"""The port's acquisition variants (gnss_sdr_tpu_torch.ops.acquisition)
against the JAX package on tests/test_acq_variants.py's cases, on the CPU.

The same numpy-seeded inputs go through both packages: the Galileo E1 8 ms
two-hypothesis search, QuickSync with its folded-phase resolution, CCCWSR
data + pilot combining and the Tong detector. Peak cell (code phase and
Doppler bin) equal, the CFAR / max-power statistics and the peak within
rtol 1e-3 (tests/test_torch_acquisition.py's tolerance: the two FFTs round
differently), and the JAX test's own assertions on the port's results.
Then the full receiver with ``acq_variant="e1_8ms"`` (the INI's
Galileo_E1_PCPS_8ms_Ambiguous_Acquisition) through both packages: the same
channel state, PRN and handoff record, and ``rx.trk_state.carrier_freq[0]``
within 0.05 Hz of JAX's (the tracking loops' sums round differently).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gnss_sdr_tpu import constants
from gnss_sdr_tpu.config.ini import InMemoryConfiguration as JConf
from gnss_sdr_tpu.config.ini import receiver_config_from_ini as jbind
from gnss_sdr_tpu.models import codes
from gnss_sdr_tpu.ops import acquisition as jacq
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu.utils import generator
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.ops import acquisition as tacq
from gnss_sdr_tpu_torch.receiver.receiver import Receiver as TReceiver
from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig as TConfig

torch.set_num_threads(1)   # one thread per xdist worker

E1 = constants.SIGNALS["1B"]
FS_E1 = 4.092e6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.code_phase),
                                  rt.code_phase.numpy())
    np.testing.assert_array_equal(np.asarray(rj.doppler_hz),
                                  rt.doppler_hz.numpy())
    for f in ("test_cfar", "test_max_power", "magnitude"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-3)


def _e1_replica(prn: int, fs: float = FS_E1) -> np.ndarray:
    spc = int(round(fs * E1.code_period_s))
    return codes.sample_code(codes.code_chips("1B", prn), fs,
                             E1.code_rate_cps, spc,
                             boc_rate=E1.subcarrier_rate_hz)


@pytest.mark.parametrize("flip", [1, -1])
def test_pcps_8ms_matches_jax(flip):
    """tests/test_acq_variants.py:240-286: an I/NAV symbol flip at the
    4 ms period boundary costs nothing; with it, the single-hypothesis
    search (B forced to A) degrades."""
    prn, fd_true, delay_s = 11, 1500.0, 0.0004
    rep = _e1_replica(prn)
    spc = len(rep)
    cfa = np.conj(np.fft.fft(np.concatenate([rep, rep])))[None].astype(
        np.complex64)
    cfb = np.conj(np.fft.fft(np.concatenate([rep, -rep])))[None].astype(
        np.complex64)
    dop = jacq.make_doppler_grid(3000, 125)
    spchip = max(1, int(FS_E1 / E1.code_rate_cps))
    bits = np.array([1.0, flip, 1.0, flip], np.float32)
    x = generator.generate(
        E1, [generator.SatParams(prn=prn, cn0_dbhz=44.0, doppler_hz=fd_true,
                                 code_delay_s=delay_s, data_bits=bits)],
        FS_E1, 0.009, seed=10 + flip)[: 2 * spc]
    kw = dict(fs=FS_E1, samples_per_code=spc, samples_per_chip=spchip)
    rj = jacq.pcps_8ms_search(jnp.asarray(x), jnp.asarray(cfa),
                              jnp.asarray(cfb), jnp.asarray(dop), **kw)
    rt = tacq.pcps_8ms_search(_t(x), _t(cfa), _t(cfb), _t(dop), **kw)
    _assert_same(rj, rt)
    assert abs(int(rt.code_phase[0]) - round(delay_s * FS_E1)) <= 2
    assert abs(float(rt.doppler_hz[0]) - fd_true) <= 125.0
    assert float(rt.test_cfar[0]) > 2.0
    if flip == -1:
        r1 = tacq.pcps_8ms_search(_t(x), _t(cfa), _t(cfa), _t(dop), **kw)
        _assert_same(jacq.pcps_8ms_search(
            jnp.asarray(x), jnp.asarray(cfa), jnp.asarray(cfa),
            jnp.asarray(dop), **kw), r1)
        assert float(rt.test_cfar[0]) > 1.5 * float(r1.test_cfar[0])


def test_quicksync_matches_jax():
    """tests/test_acq_variants.py:149-175: fold by 2, detect in the short
    FFT, resolve the true phase on the host."""
    fs, spec = 2.5e6, constants.GPS_L1_CA
    prn, fd_true, delay = 5, 750.0, 1100
    spc = int(fs * 1e-3)
    x = generator.generate(
        spec, [generator.SatParams(prn=prn, cn0_dbhz=50.0, doppler_hz=fd_true,
                                   code_delay_s=delay / fs)], fs, 0.004,
        seed=6)[:spc]
    f = 2
    rep = codes.sample_code(codes.gps_l1ca_code(prn), fs, 1.023e6, spc)
    folded = rep[: (spc // f) * f].reshape(f, spc // f).sum(axis=0)
    cf = np.conj(np.fft.fft(folded))[None, :].astype(np.complex64)
    dop = jacq.make_doppler_grid(5000, 250)
    kw = dict(fs=fs, samples_per_code=spc, folding_factor=f,
              samples_per_chip=2)
    rj = jacq.quicksync_search(jnp.asarray(x), jnp.asarray(cf),
                               jnp.asarray(dop), **kw)
    rt = tacq.quicksync_search(_t(x), _t(cf), _t(dop), **kw)
    _assert_same(rj, rt)
    assert float(rt.test_cfar[0]) > 1.8
    folded_phase = int(rt.code_phase[0])
    assert folded_phase == delay % (spc // f)
    rkw = dict(fs=fs, folding_factor=f)
    got = tacq.resolve_folded_phase(x, rep, folded_phase,
                                    float(rt.doppler_hz[0]), **rkw)
    assert got == jacq.resolve_folded_phase(
        x, rep, folded_phase, float(rt.doppler_hz[0]), **rkw) == delay


def test_cccwsr_matches_jax():
    """tests/test_acq_variants.py:178-210: coherent E1B + E1C combining
    beats the data component alone."""
    prn, fd_true, delay_s = 3, -900.0, 0.0007
    x = generator.generate(
        E1, [generator.SatParams(prn=prn, cn0_dbhz=41.0, doppler_hz=fd_true,
                                 code_delay_s=delay_s)],
        FS_E1, 0.01, seed=8, with_pilot=True)
    rep_d = _e1_replica(prn)
    spc = len(rep_d)
    rep_p = codes.sample_code(codes.pilot_code_chips("1B", prn), FS_E1,
                              E1.code_rate_cps, spc,
                              boc_rate=E1.subcarrier_rate_hz)
    cfd = np.conj(np.fft.fft(rep_d))[None, :].astype(np.complex64)
    cfp = np.conj(np.fft.fft(rep_p))[None, :].astype(np.complex64)
    dop = jacq.make_doppler_grid(3000, 125)
    spchip = max(1, int(FS_E1 / E1.code_rate_cps))
    kw = dict(fs=FS_E1, samples_per_code=spc, samples_per_chip=spchip,
              noncoherent=2)
    xx = x[: 2 * spc]
    rj = jacq.cccwsr_search(jnp.asarray(xx), jnp.asarray(cfd),
                            jnp.asarray(cfp), jnp.asarray(dop), **kw)
    rt = tacq.cccwsr_search(_t(xx), _t(cfd), _t(cfp), _t(dop), **kw)
    _assert_same(rj, rt)
    single = tacq.pcps_search(_t(xx), _t(cfd), _t(dop), **kw)
    assert abs(int(rt.code_phase[0]) - round(delay_s * FS_E1)) <= 2
    assert float(rt.test_cfar[0]) > float(single.test_cfar[0])


def test_tong_detector_matches_jax():
    rng = np.random.default_rng(4)
    for a, b, m in ((4, 2, 20), (8, 2, 30), (3, 1, 5)):
        dj, dt = jacq.TongDetector(a, b, m), tacq.TongDetector(a, b, m)
        for _ in range(3):
            for hit in rng.random(40) < 0.6:
                assert dt.update(bool(hit)) == dj.update(bool(hit))
            dj.reset()
            dt.reset()
            assert (dt.count, dt.dwells) == (dj.count, dj.dwells) == (b, 0)
    t = tacq.TongDetector(a=4, b=2, max_dwells=20)
    assert [t.update(True), t.update(True)] == ["pending", "detected"]


def test_e1_8ms_receiver_matches_jax():
    """tests/test_acq_variants.py:289-311 through both receivers: PRN 21
    with random I/NAV symbols, acquired by the 8 ms search and tracked;
    the first tracking epoch after the handoff (its code delay and
    two-step Doppler) is the same record in both packages."""
    prn, fd_true = 21, 987.0
    rng = np.random.default_rng(3)
    bits = (1.0 - 2.0 * rng.integers(0, 2, 200)).astype(np.float32)
    x = generator.generate(
        E1, [generator.SatParams(prn=prn, cn0_dbhz=47.0, doppler_hz=fd_true,
                                 code_delay_s=0.0006, data_bits=bits)],
        FS_E1, 0.3, seed=13)
    kw = dict(signal="1B", fs=FS_E1, n_channels=1, prns=(prn,), chunk_ms=100,
              acq_variant="e1_8ms", acq_doppler_max_hz=3000.0,
              acq_doppler_step_hz=125.0)
    jrx = JReceiver(JConfig(**kw))
    trx = TReceiver(TConfig(**kw), device="cpu")
    head = trx.chunk_len + trx.n_max
    for rx in (jrx, trx):
        rx.process(x[:head])                  # the acquiring chunk
    jr, tr = jrx.channels[0].records[0], trx.channels[0].records[0]
    assert (tr.abs_start_sample, tr.epoch_index, tr.code_freq,
            tr.carrier_freq) == (jr.abs_start_sample, jr.epoch_index,
                                 jr.code_freq, jr.carrier_freq)
    for rx in (jrx, trx):
        rx.process(x[head:])
    g = jrx.groups[0]
    assert trx._acq_window(trx.groups[0]) == jrx._acq_window(g, "e1_8ms")
    jch, tch = jrx.channels[0], trx.channels[0]
    assert (tch.state, tch.prn) == (jch.state, jch.prn) == ("tracking", prn)
    got = float(trx.trk_state.carrier_freq[0])
    assert abs(got - float(jrx.trk_state.carrier_freq[0])) < 0.05
    assert abs(got - fd_true) < 60.0
    assert len(trx.channels) == 1 and trx.channels[0] is tch


def test_variant_selection_from_ini():
    """tests/test_acq_variants.py:314-337 through both bindings: the 8 ms
    and CAF names select the variant engines per group, both pass the
    port's registry and build a receiver."""
    keys = {
        "GNSS-SDR.internal_fs_sps": "12000000",
        "Channels_5X.count": "2",
        "Channels_1B.count": "2",
        "Acquisition_5X.implementation":
            "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF",
        "Acquisition_5X.CAF_window_hz": "500",
        "Acquisition_5X.both_signal_components": "true",
        "Acquisition_1B.implementation":
            "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition",
        "Tracking_5X.implementation": "Galileo_E5a_DLL_PLL_Tracking",
        "Tracking_1B.implementation": "Galileo_E1_DLL_PLL_VEML_Tracking",
    }
    want = jbind(JConf(dict(keys)))
    tconf = tini.InMemoryConfiguration(dict(keys))
    got = tini.receiver_config_from_ini(tconf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    gp = {sig: dict(items) for sig, items in got.group_params}
    assert gp["1B"]["acq_variant"] == "e1_8ms"
    assert gp["5X"]["acq_variant"] == "e5a_caf"
    rx = TReceiver(got, device="cpu")
    assert {g.signal: g.rx_cfg.acq_variant for g in rx.groups} == {
        "1B": "e1_8ms", "5X": "e5a_caf"}
