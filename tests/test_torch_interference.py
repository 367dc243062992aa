"""The port's interference ops and beamformer (gnss_sdr_tpu_torch.ops.
interference / ops.beamformer) against the JAX package's, on the CPU.

Same seeded numpy inputs through both. The median equals ``jnp.median``
exactly on even and odd lengths (the mean of the two middle values, which
``torch.median`` does not give). Pulse blanking blanks the same samples and
leaves the others bit for bit. The notch keeps and nulls the same FFT bins
on a clear CW tone (30x the noise amplitude, 0.31 MHz at 2 MSps), and its
output stays within |dy| <= 1e-4 max|y| + 1e-5 of JAX's (the two FFTs
round differently). The beamformer's weights are equal and its output
within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gnss_sdr_tpu import constants
from gnss_sdr_tpu.ops import beamformer as jbf
from gnss_sdr_tpu.ops import fft as jfft
from gnss_sdr_tpu.ops import interference as jint
from gnss_sdr_tpu.utils import generator
from gnss_sdr_tpu_torch.ops import beamformer as tbf
from gnss_sdr_tpu_torch.ops import interference as tint
from gnss_sdr_tpu_torch.ops import iq

torch.set_num_threads(1)   # one thread per xdist worker

FS = 2.0e6


def _jammed(n: int, seed: int = 0) -> np.ndarray:
    """A GPS L1 satellite in unit noise plus a CW jammer at 0.31 MHz, 30x
    the noise amplitude."""
    sats = [generator.SatParams(prn=7, cn0_dbhz=46.0, doppler_hz=1000.0,
                                code_delay_s=2.1e-4)]
    x = generator.generate(constants.GPS_L1_CA, sats, FS, n / FS, seed=seed)
    jam = 30.0 * np.exp(2j * np.pi * 0.31e6 * np.arange(len(x)) / FS)
    return (x + jam).astype(np.complex64)[:n]


@pytest.mark.parametrize("n", [1, 2, 7, 8, 255, 256, 1001])
def test_median_equals_jnp_median(n):
    v = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = float(tint.median(torch.from_numpy(v)))
    assert got == float(jnp.median(v))
    if n % 2 == 0 and n > 1:
        # the lower middle value is not the median of an even length
        assert got != float(torch.median(torch.from_numpy(v)))


@pytest.mark.parametrize("window,threshold", [(64, 10.0), (50, 6.0)])
def test_pulse_blanking_matches_jax(window, threshold):
    rng = np.random.default_rng(3)
    n = 20_037                      # a tail that fills no window
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    for a, b in ((1000, 1400), (7000, 7100), (19_990, 20_037)):
        x[a:b] *= 25.0              # pulses, the last one in the tail
    want = np.asarray(jint.pulse_blanking(iq.split(x), threshold=threshold,
                                          window=window))
    got = tint.pulse_blanking(torch.from_numpy(iq.split(x)),
                              threshold=threshold, window=window).numpy()
    assert got.shape == want.shape == (n, 2)
    np.testing.assert_array_equal(got, want)
    blanked = np.all(got == 0, axis=1)
    assert blanked[1000:1400].all() and blanked[7000:7100].all()
    segs = tint.pulse_blank_mask(torch.from_numpy(iq.split(x)), threshold,
                                 window).numpy()
    np.testing.assert_array_equal(np.repeat(segs, window),
                                  blanked[: len(segs) * window])
    n_full = (n // window) * window
    # the tail passes unblanked
    np.testing.assert_array_equal(got[n_full:], iq.split(x)[n_full:])


def test_pulse_blanking_short_block_passes():
    x = np.ones(10, np.complex64) * 5
    got = tint.pulse_blanking(torch.from_numpy(iq.split(x)), window=64)
    np.testing.assert_array_equal(got.numpy(), iq.split(x))


@pytest.mark.parametrize("n", [8192, 20_000])
def test_notch_matches_jax(n):
    x = _jammed(n)
    x2 = iq.split(x)
    want = np.asarray(jint.notch_excision(x2, threshold_db=12.0))
    got = tint.notch_excision(torch.from_numpy(x2), threshold_db=12.0).numpy()
    # the masks: JAX's four-step FFT against torch.fft, bin for bin
    pj = np.abs(np.asarray(jfft.fft(jnp.asarray(x)))) ** 2
    keep_j = pj < np.float32(jnp.median(pj)) * np.float32(10.0 ** 1.2)
    keep_t = tint.notch_keep_mask(torch.from_numpy(x2), 12.0).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)
    # the tone's bin and its leakage only
    assert not keep_t[int(round(0.31e6 / FS * n))]
    assert (~keep_t).sum() < n // 20
    tol = 1e-4 * np.abs(want).max() + 1e-5
    assert np.abs(got - want).max() <= tol
    # the jammer is gone: output power near the noise + signal floor
    assert np.mean(np.sum(got ** 2, axis=1)) < 2.5


def test_beamformer_matches_jax():
    rng = np.random.default_rng(9)
    for n_el, theta in ((4, 0.0), (3, 0.4), (8, -1.1)):
        w = tbf.ula_steering_weights(n_el, theta, 0.5)
        np.testing.assert_array_equal(w, jbf.ula_steering_weights(
            n_el, theta, 0.5))
        arr = (rng.standard_normal((n_el, 5000))
               + 1j * rng.standard_normal((n_el, 5000))).astype(np.complex64)
        a2 = np.stack([arr.real, arr.imag], -1).astype(np.float32)
        want = np.asarray(jbf.beamform(a2, iq.split(w)))
        got = tbf.beamform(torch.from_numpy(a2),
                           torch.from_numpy(iq.split(w))).numpy()
        assert got.shape == want.shape == (5000, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
