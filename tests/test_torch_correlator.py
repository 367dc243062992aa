"""Port multicorrelator (gnss_sdr_tpu_torch.ops.correlator) against the JAX
package: its plain PyTorch version against JAX ``batch_epoch_correlate`` for
C in {1, 8, 128} and table_rate in {1, 2}, and against the Pallas kernel in
interpret mode on the ``case`` and BOC inputs of tests/test_correlator.py,
all at rtol 2e-4 / atol 2e-3 (that file's tolerance). The CUDA kernel is held
against the plain version on the card by the ``gpu`` test, which needs no
JAX (the card's machine has none), so JAX is imported by the tests that use
it."""

import pathlib
import re

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch.ops import correlator as tcorr

torch.set_num_threads(1)   # one thread per xdist worker

RTOL, ATOL = 2e-4, 2e-3
NAMES = ("chunk", "offsets", "n_samp", "codes", "rem", "cps", "frac", "step",
         "taps")


def _inputs(n_ch: int, table_rate: int, seed: int, n_max: int = 2064):
    """Tracking-shaped inputs: epoch windows of ~2000 samples at random
    offsets of a chunk, live code phases and Dopplers."""
    rng = np.random.default_rng(seed)
    length = 40 * n_max
    return dict(
        chunk=rng.standard_normal((length, 2)).astype(np.float32),
        offsets=rng.integers(0, length - n_max, n_ch).astype(np.int32),
        n_samp=rng.integers(1990, n_max + 1, n_ch).astype(np.int32),
        codes=rng.choice([-1.0, 1.0], (n_ch, 1023 * table_rate)
                         ).astype(np.float32),
        rem=rng.uniform(0.0, 0.6, n_ch).astype(np.float32),
        cps=(1.023e6 * (1 + rng.uniform(-3e-6, 3e-6, n_ch)) / 2e6
             ).astype(np.float32),
        frac=rng.uniform(0.0, 1.0, n_ch).astype(np.float32),
        step=rng.uniform(-2.5e-3, 2.5e-3, n_ch).astype(np.float32),
        taps=np.array([-0.5, 0.0, 0.5], np.float32),
        n_max=n_max)


def _port(c, table_rate=1, device="cpu"):
    args = [torch.from_numpy(np.asarray(c[k])).to(device) for k in NAMES]
    return tcorr.batch_epoch_correlate(*args, n_max=c["n_max"],
                                       table_rate=table_rate)


def _jax(c, table_rate=1):
    jnp = pytest.importorskip("jax.numpy")
    from gnss_sdr_tpu.ops import correlator as jcorr
    return np.asarray(jcorr.batch_epoch_correlate(
        *(jnp.asarray(c[k]) for k in NAMES), n_max=c["n_max"],
        table_rate=table_rate))


@pytest.mark.parametrize("n_ch", [1, 8, 128])
@pytest.mark.parametrize("table_rate", [1, 2])
def test_plain_matches_jax_gather(n_ch, table_rate):
    c = _inputs(n_ch, table_rate, seed=10 * n_ch + table_rate)
    np.testing.assert_allclose(_port(c, table_rate).numpy(),
                               _jax(c, table_rate), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def case():
    # the `case` fixture of tests/test_correlator.py:33-47
    rng = np.random.default_rng(5)
    n_ch, n_max, lc = 3, 256, 1023
    chunk = (rng.standard_normal(2048)
             + 1j * rng.standard_normal(2048)).astype(np.complex64)
    return dict(
        chunk=np.stack([chunk.real, chunk.imag], -1).astype(np.float32),
        codes=rng.choice([-1.0, 1.0], (n_ch, lc)).astype(np.float32),
        offsets=np.array([10, 500, 1700], np.int32),
        n_samp=np.array([200, 240, 193], np.int32),
        rem=np.array([0.01, 0.2, 0.13], np.float32),
        cps=np.array([0.25575, 0.2558, 0.2557], np.float32),
        frac=np.array([0.9, 0.1, 0.5], np.float32),
        step=np.array([0.001, -0.002, 0.0007], np.float32),
        taps=np.array([-0.5, 0.0, 0.5], np.float32), n_max=n_max)


def _pallas(c, table_rate=1):
    jnp = pytest.importorskip("jax.numpy")
    from gnss_sdr_tpu.ops.correlator_pallas import pallas_epoch_correlate
    return np.asarray(pallas_epoch_correlate(
        *(jnp.asarray(c[k]) for k in NAMES), n_max=c["n_max"],
        table_rate=table_rate, interpret=True))


def test_plain_matches_pallas_interpret(case):
    np.testing.assert_allclose(_port(case).numpy(), _pallas(case),
                               rtol=RTOL, atol=ATOL)


def test_plain_matches_pallas_boc(case):
    # tests/test_correlator.py:79 (test_boc_table_rate)
    c = dict(case)
    codes2 = np.repeat(c["codes"], 2, axis=1).astype(np.float32)
    codes2[:, 1::2] *= -1.0
    c["codes"] = codes2
    np.testing.assert_allclose(_port(c, 2).numpy(), _pallas(c, 2),
                               rtol=RTOL, atol=ATOL)


def test_wrapper_contract():
    c = _inputs(4, 1, seed=3)
    c["n_samp"][1] = 0
    out = _port(c)
    assert out.shape == (4, 3, 2) and out.dtype == torch.float32
    assert torch.all(out[1] == 0)
    # int8 uploads are dequantized before the correlation
    q = np.clip(np.rint(c["chunk"] * 16), -127, 127).astype(np.int8)
    c8 = dict(c, chunk=q)
    np.testing.assert_allclose(
        _port(c8).numpy(), _port(dict(c, chunk=q.astype(np.float32) / 16)).numpy(),
        rtol=1e-6, atol=1e-5)
    # per-tap components need [C, G, Lt] tables
    with pytest.raises(ValueError):
        tcorr.batch_epoch_correlate(
            *(torch.from_numpy(np.asarray(c[k])) for k in NAMES),
            n_max=c["n_max"], tap_components=(0, 0, 1))
    bad = dict(c, offsets=c["offsets"].astype(np.int64))
    with pytest.raises(ValueError):
        _port(bad)
    # the CPU path never counts a kernel launch
    before = tcorr.launches
    _port(c)
    assert tcorr.launches == before


def test_kernel_library_keyed_on_source(tmp_path, monkeypatch):
    """The built library's name hashes the source and the nvcc flags, so an
    edited source is rebuilt, never served stale from build/kernels."""
    from gnss_sdr_tpu_torch.utils import cuda_build

    real = cuda_build.library_path("correlator")
    assert real.parent == cuda_build.BUILD_DIR
    assert real.name.startswith("correlator-") and real.suffix == ".so"
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// v1\n")
    v1 = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == v1
    (tmp_path / "k.cu").write_text("// v2\n")
    assert cuda_build.library_path("k") != v1
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS[:-2])
    (tmp_path / "k.cu").write_text("// v1\n")
    assert cuda_build.library_path("k") != v1


def test_block_sum_is_the_kernels_order():
    """The plain version's sum repeats the kernels' block order
    (csrc/epoch_correlate.cuh), written out here thread by thread in float32:
    each thread adds samples t, t + NT, ... in order; a shuffle tree halves
    each warp; the warps are added in order. It stays an accurate sum."""
    rng = np.random.default_rng(7)
    p = (rng.standard_normal((2, 3, 2, 2064)) * 100).astype(np.float32)
    got = tcorr._block_sum(torch.from_numpy(p)).numpy()
    nt = tcorr.BLOCK_THREADS
    acc = np.zeros(p.shape[:-1] + (nt,), np.float32)
    for start in range(0, p.shape[-1], nt):
        part = p[..., start:start + nt]
        acc[..., : part.shape[-1]] += part
    lanes = acc.reshape(p.shape[:-1] + (nt // 32, 32))
    for d in (16, 8, 4, 2, 1):
        lanes = lanes[..., :d] + lanes[..., d:2 * d]
    want = np.zeros(p.shape[:-1], np.float32)
    for w in range(nt // 32):
        want += lanes[..., w, 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, p.astype(np.float64).sum(-1), rtol=1e-5,
                               atol=1e-2)
    # both kernels sum over that many lanes: the shared header's one
    # constant; K1 launches blocks of that many threads, K2 splits each
    # channel's lanes over the cluster's blocks (GNSS_THREADS / m threads
    # each, C m blocks)
    csrc = pathlib.Path(tcorr.__file__).resolve().parents[1] / "csrc"
    src = (csrc / "epoch_correlate.cuh").read_text()
    assert re.search(r"#define GNSS_THREADS (\d+)", src).group(1) == str(nt)
    for name in ("correlator.cu", "tracking.cu"):
        src = (csrc / name).read_text()
        assert "__launch_bounds__(GNSS_THREADS)" in src, name
    assert re.search(r"<<<[^,]+, GNSS_THREADS,",
                     (csrc / "correlator.cu").read_text())
    src = (csrc / "tracking.cu").read_text()
    assert "cfg.blockDim = dim3(GNSS_THREADS / p.cluster, 1, 1);" in src
    assert "cfg.gridDim = dim3(p.n_ch * p.cluster, 1, 1);" in src


def test_kernel_library_keyed_on_headers(tmp_path, monkeypatch):
    """Every shared header csrc/*.cuh enters each library's name, so an
    edited header is rebuilt too, never served stale from build/kernels."""
    from gnss_sdr_tpu_torch.utils import cuda_build

    assert (cuda_build.CSRC / "epoch_correlate.cuh").exists()
    assert cuda_build.library_path("tracking") != cuda_build.library_path(
        "correlator")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    v1 = cuda_build.library_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    v2 = cuda_build.library_path("k")
    assert v2 != v1
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert cuda_build.library_path("k") != v2
    (tmp_path / "other.cuh").unlink()
    assert cuda_build.library_path("k") == v2


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    for n_ch, table_rate in [(8, 1), (128, 1), (8, 2)]:
        c = _inputs(n_ch, table_rate, seed=n_ch + table_rate)
        c["n_samp"][0] = 0
        before = tcorr.launches
        out = _port(c, table_rate, device="cuda")
        assert tcorr.launches == before + 1
        args = [torch.from_numpy(np.asarray(c[k])).cuda() for k in NAMES]
        ref = tcorr.epoch_correlate_plain(*args, n_max=c["n_max"],
                                          table_rate=table_rate)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert torch.all(out[0] == 0)
