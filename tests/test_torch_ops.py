"""Port device ops (gnss_sdr_tpu_torch.ops) against the JAX package on the
CPU, with the same numpy-seeded inputs through both: the quantized upload
formats bit for bit, the discriminators, loop filters and C/N0 estimators on
random [C] inputs (float32, rtol 1e-5, atol 1e-6), and the FFT window-length
policy for every n in 1000..70000."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gnss_sdr_tpu.ops import cn0 as jcn0
from gnss_sdr_tpu.ops import discriminators as jdisc
from gnss_sdr_tpu.ops import fft as jfft
from gnss_sdr_tpu.ops import iq as jiq
from gnss_sdr_tpu.ops import kalman as jkalman
from gnss_sdr_tpu.ops import loop_filters as jlf
from gnss_sdr_tpu_torch.ops import cn0 as tcn0
from gnss_sdr_tpu_torch.ops import discriminators as tdisc
from gnss_sdr_tpu_torch.ops import fft as tfft
from gnss_sdr_tpu_torch.ops import iq as tiq
from gnss_sdr_tpu_torch.ops import kalman as tkalman
from gnss_sdr_tpu_torch.ops import loop_filters as tlf

torch.set_num_threads(1)   # one thread per xdist worker

C = 64
RTOL, ATOL = 1e-5, 1e-6


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def rnd():
    rng = np.random.default_rng(2024)

    def f32(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def cplx(scale=100.0):
        return (f32(C) * scale + 1j * f32(C) * scale).astype(np.complex64)
    return dict(f32=f32, cplx=cplx, rng=rng)


def test_dequant4_bit_exact_all_bytes():
    b = np.arange(256, dtype=np.uint8)
    j = np.asarray(jiq.dequant4(jnp.asarray(b)))
    t = tiq.dequant4(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))
    np.testing.assert_array_equal(tiq.dequant4_host(b), jiq.dequant4_host(b))


def test_quantizers_match_jax(rnd):
    x = (rnd["rng"].standard_normal(4096)
         + 1j * rnd["rng"].standard_normal(4096)).astype(np.complex64) * 3.0
    for name in ("quantize8", "quantize4"):
        np.testing.assert_array_equal(getattr(tiq, name)(x),
                                      getattr(jiq, name)(x))
    assert tiq.measure_rms(x) == jiq.measure_rms(x)
    q8 = jiq.quantize8(x)
    np.testing.assert_array_equal(
        tiq.dequant(torch.from_numpy(q8)).numpy().view(np.int32),
        np.asarray(jiq.dequant(jnp.asarray(q8))).view(np.int32))
    np.testing.assert_array_equal(tiq.combine(tiq.split(x)), x)
    # as_iq2 / as_complex dispatch on dtype exactly like the JAX versions
    q4 = jiq.quantize4(x)
    for arr in (q8, q4, tiq.split(x)):
        np.testing.assert_array_equal(
            tiq.as_iq2(torch.from_numpy(arr)).numpy(),
            np.asarray(jiq.as_iq2(jnp.asarray(arr))))
        np.testing.assert_array_equal(
            tiq.as_complex(torch.from_numpy(arr)).numpy(),
            np.asarray(jiq.as_complex(jnp.asarray(arr))))


def test_dequant_checks_shape():
    with pytest.raises(ValueError):
        tiq.dequant4(torch.zeros((16, 2), dtype=torch.uint8))
    with pytest.raises(ValueError):
        tiq.dequant(torch.zeros((16, 3), dtype=torch.int8))
    with pytest.raises(TypeError):
        tiq.dequant(torch.zeros((16, 2), dtype=torch.float32))


def test_discriminators_match_jax(rnd):
    e, p, l, prev = rnd["cplx"](), rnd["cplx"](), rnd["cplx"](), rnd["cplx"]()
    dt = rnd["f32"](C, lo=1e-3, hi=2e-2)
    T = torch.from_numpy
    J = jnp.asarray
    _close(tdisc.dll_nc_emlp(T(e), T(l), 0.5), jdisc.dll_nc_emlp(J(e), J(l), 0.5))
    _close(tdisc.dll_nc_vemlp(T(prev), T(e), T(l), T(p)),
           jdisc.dll_nc_vemlp(J(prev), J(e), J(l), J(p)))
    _close(tdisc.pll_costas(T(p)), jdisc.pll_costas(J(p)))
    _close(tdisc.pll_atan2(T(p)), jdisc.pll_atan2(J(p)))
    _close(tdisc.fll_atan2(T(prev), T(p), T(dt)),
           jdisc.fll_atan2(J(prev), J(p), J(dt)))


def _atan_inputs(n, seed=41):
    """float32 inputs over atan32's five reduction intervals: normal and
    Cauchy draws, a uniform band around them, log-uniform magnitudes over
    70 octaves each way, and each interval's bounds, 2^25, 0, inf."""
    rng = np.random.default_rng(seed)
    q = n // 4
    words = np.array([0x3EDFFFFF, 0x3EE00000, 0x3F2FFFFF, 0x3F300000,
                      0x3F97FFFF, 0x3F980000, 0x401BFFFF, 0x401C0000,
                      0x4BFFFFFF, 0x4C000000], np.uint32).view(np.float32)
    edges = np.concatenate([words, -words,
                            [0.0, -0.0, np.inf, -np.inf, 1e-45, 3e38]])
    return np.concatenate([
        rng.standard_normal(q), rng.standard_normal(q) / rng.standard_normal(q),
        rng.uniform(-3.0, 3.0, q),
        np.exp(rng.uniform(-48.0, 48.0, q)) * rng.choice([-1.0, 1.0], q),
        edges]).astype(np.float32)


def test_atan32_is_xla_cpu_arctan():
    """The JAX reference's CPU backend computes jnp.arctan of float32 as the
    C library's atanf (on the test machine's glibc: fdlibm's __atanf); the
    port's atan32 writes that function out op for op. Bit for bit over 10^6
    inputs against jnp.arctan, and jnp.arctan against the C library's atanf
    called through ctypes on a 2 x 10^4 sample; torch.atan differs from both
    on a few % of them."""
    import ctypes
    import ctypes.util

    x = _atan_inputs(10 ** 6)
    want = np.asarray(jnp.arctan(jnp.asarray(x)))
    got = tdisc.atan32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (torch.atan(torch.from_numpy(x)).numpy() != want).mean() > 0.01
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.atanf.restype = ctypes.c_float
    libm.atanf.argtypes = [ctypes.c_float]
    sample = x[:: len(x) // 20000]
    c = np.array([libm.atanf(float(v)) for v in sample], np.float32)
    np.testing.assert_array_equal(
        c.view(np.int32), want[:: len(x) // 20000].view(np.int32))


def test_discriminator_signs():
    """tests/test_tracking.py:45 conventions: early > late -> positive code
    error; prompt rotated by +phi -> positive phase error."""
    early = torch.tensor([10.0 + 0j], dtype=torch.complex64)
    late = torch.tensor([5.0 + 0j], dtype=torch.complex64)
    assert float(tdisc.dll_nc_emlp(early, late)[0]) > 0
    p = torch.tensor([np.exp(1j * 0.3)], dtype=torch.complex64)
    assert float(tdisc.pll_costas(p)[0]) == pytest.approx(0.3 / (2 * np.pi),
                                                          rel=1e-5)


def test_loop_filters_match_jax(rnd):
    f = rnd["f32"]
    acc1, acc2 = f(C, lo=-2e3, hi=2e3), f(C, lo=-50, hi=50)
    pe, fe = f(C, lo=-0.2, hi=0.2), f(C, lo=-20, hi=20)
    dt = f(C, lo=1e-3, hi=2e-2)
    pbw, fbw = f(C, lo=5, hi=40), f(C, lo=0, hi=10)
    T = torch.from_numpy
    J = jnp.asarray
    ts, tout = tlf.pll3_update(tlf.Loop3State(T(acc1), T(acc2)), T(pe), T(fe),
                               T(dt), T(pbw), T(fbw))
    js, jout = jlf.pll3_update(jlf.Loop3State(J(acc1), J(acc2)), J(pe), J(fe),
                               J(dt), J(pbw), J(fbw))
    _close(tout, jout)
    _close(ts.acc1, js.acc1)
    _close(ts.acc2, js.acc2)
    dbw = f(C, lo=1, hi=4)
    ts, tout = tlf.dll2_update(tlf.Loop2State(T(acc1)), T(pe), T(dt), T(dbw))
    js, jout = jlf.dll2_update(jlf.Loop2State(J(acc1)), J(pe), J(dt), J(dbw))
    _close(tout, jout)
    _close(ts.acc1, js.acc1)


def test_cn0_matches_jax(rnd):
    f = rnd["f32"]
    moments = [f(C, lo=0, hi=100), f(C, lo=1e3, hi=2e4), f(C, lo=-1e3, hi=1e3),
               f(C, lo=1e3, hi=2e4)]
    p = rnd["cplx"]()
    valid = rnd["rng"].random(C) > 0.3
    coh = f(C, lo=1e-3, hi=2e-2)
    T = torch.from_numpy
    J = jnp.asarray
    ts = tcn0.cn0_update(tcn0.Cn0State(*map(T, moments)), T(p), T(valid))
    js = jcn0.cn0_update(jcn0.Cn0State(*map(J, moments)), J(p), J(valid))
    for a, b in zip(ts, js):
        _close(a, b)
    np.testing.assert_allclose(tcn0.cn0_dbhz(ts, T(coh)).numpy(),
                               np.asarray(jcn0.cn0_dbhz(js, J(coh))),
                               rtol=RTOL, atol=1e-4)
    _close(tcn0.carrier_lock_metric(ts), jcn0.carrier_lock_metric(js))


def test_kf_init_cov_matches_jax():
    np.testing.assert_array_equal(tkalman.kf_init_cov(5),
                                  jkalman.kf_init_cov(5))


def test_fft_window_policy_matches_jax():
    ns = np.arange(1000, 70001)
    mine = np.array([tfft.is_friendly(int(n)) for n in ns])
    ref = np.array([jfft.is_friendly(int(n)) for n in ns])
    np.testing.assert_array_equal(mine, ref)
    # friendly_len(n) is the next friendly length at or above n
    nxt = np.empty(len(ns) + 1, np.int64)
    nxt[-1] = jfft.friendly_len(70001)
    for i in range(len(ns) - 1, -1, -1):
        nxt[i] = ns[i] if ref[i] else nxt[i + 1]
    for n in list(range(1000, 1100)) + [2039, 4078, 16381, 65521, 69997]:
        assert tfft.friendly_len(n) == jfft.friendly_len(n) == nxt[n - 1000]
    assert tfft.next_composite_pow2(2000) == jfft.next_composite_pow2(2000)


def test_fft_normalisation_matches_jax(rnd):
    x = (rnd["rng"].standard_normal((3, 2000))
         + 1j * rnd["rng"].standard_normal((3, 2000))).astype(np.complex64)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tfft.fft(xt).numpy(), np.asarray(jfft.fft(x)),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(tfft.ifft(xt).numpy(), np.asarray(jfft.ifft(x)),
                               rtol=1e-4, atol=1e-6)
