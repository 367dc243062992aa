"""The port's input-filter chain (``config.ini.input_filter_from_ini``, the
receiver's ``input_filter`` argument) and ``ops/fir.py``'s
``freq_translate`` / ``direct_resample`` against the JAX package's, on the
CPU.

Every filter JAX builds from INI (pulse blanking, notch, notch lite,
frequency translation, beamformer) is built by both packages from the same
keys and fed the same seeded blocks in turn: outputs within
|dy| <= 1e-4 max|y| + 1e-5 (pulse blanking bit for bit; the frequency
translation within 1e-3 rad, where JAX's float32 phase is sound). The
port's ``freq_translate`` stays within 1e-3 rad of float64 numpy 4e7
samples into a stream, where JAX's phase is off by up to pi. The shipped
notch conf restores acquisition on the JAX test's cached ``jam_e2e``
capture (read only, never written): acquisition only, no tracking run.
"""

import pathlib

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.ops import fir as jfir
from gnss_sdr_tpu.ops import iq as jiq
from gnss_sdr_tpu.utils import fixture_cache
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
from gnss_sdr_tpu_torch.models import codes
from gnss_sdr_tpu_torch.ops import acquisition as tacq
from gnss_sdr_tpu_torch.ops import fir as tfir
from gnss_sdr_tpu_torch.ops import iq
from gnss_sdr_tpu_torch.receiver import receiver as trx
from gnss_sdr_tpu_torch.utils import scenario as tscen

torch.set_num_threads(1)   # one thread per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
FS = 2.0e6


def _both(pairs: dict):
    jc, tc = jini.InMemoryConfiguration(), tini.InMemoryConfiguration()
    for k, v in pairs.items():
        jc.set_property(k, v)
        tc.set_property(k, v)
    return jc, tc


def _phase_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(np.angle(a * np.conj(b))).max())


def test_pass_through_and_unknown():
    for impl in ("Pass_Through", "", "Fir_Filter"):
        _, tc = _both({"InputFilter.implementation": impl})
        assert tini.input_filter_from_ini(tc) is None
    _, tc = _both({})
    assert tini.input_filter_from_ini(tc) is None
    # a translation by 0 Hz is no filter, as in the JAX package
    jc, tc = _both({"InputFilter.implementation": "Freq_Xlating_Fir_Filter"})
    assert jini.input_filter_from_ini(jc) is None
    assert tini.input_filter_from_ini(tc, device="cpu") is None
    jc, tc = _both({"InputFilter.implementation": "Quantum_Filter"})
    with pytest.raises(NotImplementedError, match="Quantum_Filter"):
        jini.input_filter_from_ini(jc)
    with pytest.raises(NotImplementedError, match="Quantum_Filter"):
        tini.input_filter_from_ini(tc, device="cpu")


FILTERS = {
    "Pulse_Blanking_Filter": {"InputFilter.threshold": 8.0,
                              "InputFilter.segments_est": 40},
    "Notch_Filter": {"InputFilter.threshold_db": 12.0},
    "Notch_Filter_Lite": {"InputFilter.threshold_db": 15.0},
    "Freq_Xlating_Fir_Filter": {"InputFilter.IF": 50_000.0,
                                "InputFilter.sampling_frequency": FS},
    "Beamformer_Filter": {"InputFilter.n_elements": 3,
                          "InputFilter.theta_deg": 20.0},
}


@pytest.mark.parametrize("impl", sorted(FILTERS))
def test_chain_from_ini_matches_jax(impl):
    jc, tc = _both({"InputFilter.implementation": impl, **FILTERS[impl]})
    jf = jini.input_filter_from_ini(jc)
    tf = tini.input_filter_from_ini(tc, device="cpu")
    assert tf.name == impl and tf.device == torch.device("cpu")
    rng = np.random.default_rng(5)
    for k, n in enumerate((8000, 8000, 4000)):
        shape = (3, n) if impl == "Beamformer_Filter" else (n,)
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        if impl.startswith("Notch"):
            x += 30.0 * np.exp(2j * np.pi * 0.31e6 * np.arange(n) / FS)
        if impl == "Pulse_Blanking_Filter":
            x[1000 + 300 * k: 1600 + 300 * k] *= 20.0
        want, got = np.asarray(jf(x)), tf(x)
        assert got.dtype == np.complex64 and got.shape == want.shape == (n,)
        if impl == "Pulse_Blanking_Filter":
            np.testing.assert_array_equal(got, want)
        elif impl == "Freq_Xlating_Fir_Filter":
            assert _phase_err(got, want) <= 1e-3
            np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-5)
        else:
            tol = 1e-4 * np.abs(want).max() + 1e-5
            assert np.abs(got - want).max() <= tol
    assert tf.calls == 3 and tf.seconds > 0.0


@pytest.mark.parametrize("n0,f_hz", [(0, 625e3), (4096, 625e3),
                                     (60_000, 20e3)])
def test_freq_translate_matches_jax_where_sound(n0, f_hz):
    rng = np.random.default_rng(n0)
    z = np.exp(1j * rng.uniform(0, 2 * np.pi, 4096)).astype(np.complex64)
    want = jiq.combine(np.asarray(jfir.freq_translate(jiq.split(z), f_hz,
                                                      FS, n0=n0)))
    got = iq.combine(tfir.freq_translate(torch.from_numpy(iq.split(z)),
                                         f_hz, FS, n0=n0).numpy())
    assert _phase_err(got, want) <= 1e-3


def test_freq_translate_exact_deep_into_a_stream():
    n0 = 40_000_000                # 20 s at 2 MSps
    rng = np.random.default_rng(1)
    z = np.exp(1j * rng.uniform(0, 2 * np.pi, 4096)).astype(np.complex64)
    n = n0 + np.arange(len(z), dtype=np.int64)
    ref = z * np.exp(-2j * np.pi * ((625e3 / FS) * n % 1.0))
    got = iq.combine(tfir.freq_translate(torch.from_numpy(iq.split(z)),
                                         625e3, FS, n0=n0).numpy())
    assert _phase_err(got, ref) <= 1e-3
    # the JAX package's float32 phase has lost the carrier there
    jax_out = jiq.combine(np.asarray(jfir.freq_translate(
        jiq.split(z), 625e3, FS, n0=n0)))
    assert _phase_err(jax_out, ref) > 1.0


@pytest.mark.parametrize("num,den,n_out", [(2, 5, 1000), (3, 2, 3000),
                                           (1, 1, 4000)])
def test_direct_resample_matches_jax(num, den, n_out):
    rng = np.random.default_rng(num * 10 + den)
    x2 = rng.standard_normal((5000, 2)).astype(np.float32)
    want = np.asarray(jfir.direct_resample(x2, num, den, n_out))
    got = tfir.direct_resample(torch.from_numpy(x2), num, den, n_out).numpy()
    np.testing.assert_array_equal(got, want)


def _jam_e2e():
    """The JAX test's jammed scenario (test_input_filter_chain.py): its
    cached capture, read only, plus the CW jammer."""
    def _refuse():
        raise RuntimeError("the jam_e2e fixture is not cached")
    x = fixture_cache.cached_iq(
        "jam_e2e", dict(duration_s=4.0, n_sats=5, cn0_dbhz=47.0, fs=FS,
                        seed=3), _refuse)
    x = np.asarray(x[:200_000])     # the first 100 ms block
    jam = 30.0 * np.exp(2j * np.pi * 0.31e6 * np.arange(len(x)) / FS)
    return (x + jam).astype(np.complex64)


def _detected(block: np.ndarray, prns) -> dict:
    """The receiver's PCPS acquisition (2 ms, two dwells, CFAR 2.0) of
    ``prns`` on a block: {prn: (doppler, code phase)} of those detected."""
    spc = 2000
    cf = np.stack([iq.split(np.conj(np.fft.fft(codes.sample_code(
        codes.gps_l1ca_code(p), FS, 1.023e6, spc)))) for p in prns])
    res = tacq.pcps_search(
        torch.from_numpy(iq.split(np.array(block[: 2 * spc]))),
        torch.from_numpy(cf),
        torch.from_numpy(tacq.make_doppler_grid(5000.0, 250.0)), fs=FS,
        samples_per_code=spc, samples_per_chip=2, noncoherent=2)
    return {p: (float(res.doppler_hz[i]), int(res.code_phase[i]))
            for i, p in enumerate(prns) if float(res.test_cfar[i]) >= 2.0}


def test_notch_conf_restores_acquisition_on_jam_e2e():
    conf = ROOT / "conf" / "gps_l1_notch.conf"
    jf = jini.input_filter_from_ini(jini.FileConfiguration(conf))
    tf = tini.input_filter_from_ini(tini.FileConfiguration(conf),
                                    device="cpu")
    jammed = _jam_e2e()
    want, got = np.asarray(jf(jammed)), tf(jammed)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5
    prns = tscen.build_gps_l1_scenario(duration_s=4.0, n_sats=5,
                                       cn0_dbhz=47.0, fs=FS).prns
    clean = _detected(got, prns)
    assert len(clean) >= 4, clean
    assert len(clean) > len(_detected(jammed, prns))
    # JAX's notched block acquires the same satellites at the same cells
    assert _detected(want, prns) == clean


def test_receiver_filters_source_rate_blocks():
    """run_file_source / step_source hand the filter the source-rate blocks
    before the rate conditioner, as the JAX package's loops do."""
    seen = []

    def flt(block):
        seen.append(len(block))
        return block

    x = np.zeros(int(0.25 * 4e6), np.complex64)
    rx = trx.Receiver(trx.ReceiverConfig(signal="1C", fs=FS, n_channels=1,
                                         prns=(1,)), device="cpu")
    rx.run_file_source(ArraySignalSource(x, 4e6), input_filter=flt)
    assert seen == [400_000, 400_000, 200_000]
    seen.clear()
    src = ArraySignalSource(x[:300_000], FS)
    while rx.step_source(src, input_filter=flt):
        pass
    assert seen == [200_000, 100_000]
