"""The port's Kalman filter functions (gnss_sdr_tpu_torch.ops.kalman)
against the JAX package: ``pow32`` (the C library's powf, written out),
``phase_meas_var_cyc2`` and ``kf_update`` equal JAX's compiled functions
bit for bit on random float32 inputs (10^5 exponents, 2 x 10^4 covariance
updates): the port writes out the roundings XLA's CPU backend gives them
(ops/kalman.py's docstring lists them). The tracking loop with the filter:
tests/test_torch_kalman_ramp.py.

Three tests a file (as tests/test_torch_kalman_ramp.py): ``--dist
loadfile`` queues files by their number of tests, most first, ties in
collection order (pytest-xdist 3.8.0, ``LoadScopeScheduling`` with its
default ``loadscopereorder``), so a file of three or fewer queues behind
the suite's longest file (tests/test_e2e_l2c.py, three tests) instead of
ahead of it.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from gnss_sdr_tpu.ops import kalman as jk
from gnss_sdr_tpu_torch.ops import kalman as tk

torch.set_num_threads(1)   # one thread per xdist worker


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def test_pow32_equals_jax():
    rng = np.random.default_rng(1)
    y = np.concatenate([rng.uniform(1.0, 6.0, 60000),
                        rng.uniform(-30.0, 30.0, 40000)]).astype(np.float32)
    want = jax.jit(lambda v: jnp.power(jnp.float32(10.0), v))(y)
    got = tk.pow32(10.0, torch.from_numpy(y))
    assert np.array_equal(_bits(got), _bits(want))
    # torch.pow does not give them (why pow32 exists)
    assert not np.array_equal(
        _bits(torch.pow(torch.tensor(10.0), torch.from_numpy(y))),
        _bits(want))


def test_phase_meas_var_equals_jax():
    rng = np.random.default_rng(2)
    n = 50000
    cn0 = rng.uniform(0.0, 70.0, n).astype(np.float32)
    coh = np.concatenate([rng.uniform(1e-4, 2e-2, n - 4),
                          [1e-4, 1e-3, 2e-2, 4e-3]]).astype(np.float32)
    want = jax.jit(jk.phase_meas_var_cyc2)(cn0, coh)
    got = tk.phase_meas_var_cyc2(torch.from_numpy(cn0), torch.from_numpy(coh))
    assert np.array_equal(_bits(got), _bits(want))


def test_kf_update_equals_jax():
    """2 x 10^4 random predict + update steps: covariances near the
    loop's (the phase, frequency and rate scales of kf_init_cov, positive
    definite), the intervals of 1-20 ms epochs and extensions."""
    rng = np.random.default_rng(3)
    n = 20000
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    scale = np.array([0.01, 20.0, 20.0], np.float32)
    p = ((a @ a.transpose(0, 2, 1)) * scale[None, :, None]
         * scale[None, None, :]).astype(np.float32)
    args = (p, rng.normal(0.0, 50.0, n).astype(np.float32),
            rng.normal(0.0, 3000.0, n).astype(np.float32),
            rng.normal(0.0, 0.05, n).astype(np.float32),
            (rng.choice([1e-3, 2e-3, 4e-3, 2e-2], n)
             * rng.uniform(0.999, 1.001, n)).astype(np.float32),
            rng.uniform(1e-4, 1e-2, n).astype(np.float32))
    want = jax.jit(jk.kf_update)(*args)
    got = tk.kf_update(*(torch.from_numpy(x) for x in args))
    for name, w, g in zip(("p", "freq", "accel", "dphi"), want, got):
        assert np.array_equal(_bits(g), _bits(w)), name
