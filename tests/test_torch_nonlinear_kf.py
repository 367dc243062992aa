"""The port's sigma-point filters (gnss_sdr_tpu_torch.ops.nonlinear_kf)
against the JAX package's, on the CPU, in float64.

tests/test_nonlinear_kf.py's cases through both packages on the same
seeded inputs: the cubature and unscented steps on eight random linear
models (equal to the exact linear KF, as there; the first two also to
JAX's steps within 1e-5 relative), the cubature filter on the nonlinear raw-I/Q carrier model
(JAX's convergence budgets, and JAX's state within 1e-5 relative after 400
steps), and the channel banks (``batched_predict`` / ``batched_update``
over ``torch.func.vmap``) equal to a loop of single filters and to JAX's
banks within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.ops import nonlinear_kf as jkf
from gnss_sdr_tpu_torch.ops import nonlinear_kf as tkf

torch.set_num_threads(1)   # one thread per xdist worker

RTOL = 1e-5


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=atol)


def _random_linear_case(rng, nx, ny):
    x = rng.standard_normal(nx)
    p = np.diag(5.0 * rng.uniform(0.5, 1.0, nx))
    f_mat = rng.uniform(0.1, 1.0, (nx, nx))
    q = np.diag(rng.uniform(0.1, 1.0, nx))
    h_mat = rng.uniform(0.1, 1.0, (ny, nx))
    r = np.diag(rng.uniform(0.5, 1.0, ny))
    z = h_mat @ x + rng.standard_normal(ny)
    return x, p, f_mat, q, h_mat, r, z


def _linear_kf_step(x, p, f_mat, q, h_mat, r, z):
    x_pred = f_mat @ x
    p_pred = f_mat @ p @ f_mat.T + q
    s = h_mat @ p_pred @ h_mat.T + r
    k = p_pred @ h_mat.T @ np.linalg.inv(s)
    return (x_pred, p_pred, x_pred + k @ (z - h_mat @ x_pred),
            p_pred - k @ s @ k.T)


@pytest.mark.parametrize("kind,atol", [("cubature", 1e-8),
                                       ("unscented", 1e-5)])
def test_matches_linear_kf_and_jax(kind, atol):
    jp, ju = (getattr(jkf, f"{kind}_predict"), getattr(jkf, f"{kind}_update"))
    tp, tu = (getattr(tkf, f"{kind}_predict"), getattr(tkf, f"{kind}_update"))
    rng = np.random.default_rng(7)
    with jax.enable_x64(True):
        for trial in range(8):
            nx, ny = int(rng.integers(1, 6)), int(rng.integers(1, 6))
            x, p, f_mat, q, h_mat, r, z = _random_linear_case(rng, nx, ny)
            exact = _linear_kf_step(x, p, f_mat, q, h_mat, r, z)
            ft, ht = torch.from_numpy(f_mat), torch.from_numpy(h_mat)
            xp, pp = tp(torch.from_numpy(x), torch.from_numpy(p),
                        lambda v: ft @ v, torch.from_numpy(q))
            xu, pu = tu(torch.from_numpy(z), xp, pp, lambda v: ht @ v,
                        torch.from_numpy(r))
            for got, want in zip((xp, pp, xu, pu), exact):
                np.testing.assert_allclose(got.numpy(), want, atol=atol)
            if trial >= 2:
                # JAX's eager steps compile per shape: two trials suffice
                continue
            jxp, jpp = jp(jnp.asarray(x), jnp.asarray(p),
                          lambda v: jnp.asarray(f_mat) @ v, jnp.asarray(q))
            jxu, jpu = ju(jnp.asarray(z), jxp, jpp,
                          lambda v: jnp.asarray(h_mat) @ v, jnp.asarray(r))
            for got, want in zip((xp, pp, xu, pu), (jxp, jpp, jxu, jpu)):
                _close(got.numpy(), want, atol=atol * 1e-2)


def test_cubature_tracks_nonlinear_phase():
    """tests/test_nonlinear_kf.py:75-115: the raw-I/Q carrier model,
    state [phase_cyc, freq_hz]; 400 steps through both packages."""
    rng = np.random.default_rng(3)
    dt, sigma, true_f, true_phi = 1e-3, 0.15, 37.0, 0.2
    f_mat = np.array([[1.0, dt], [0.0, 1.0]])
    q = np.diag([1e-8, 1e-2])
    r = np.eye(2) * sigma ** 2
    zs = []
    for k in range(400):
        phi = true_phi + true_f * k * dt
        zs.append(np.array([np.cos(2 * np.pi * phi), np.sin(2 * np.pi * phi)])
                  + sigma * rng.standard_normal(2))
    ft, qt, rt = (torch.from_numpy(a) for a in (f_mat, q, r))

    def h(v):
        ang = 2.0 * np.pi * v[0]
        return torch.stack([torch.cos(ang), torch.sin(ang)])

    x = torch.zeros(2, dtype=torch.float64)
    p = torch.from_numpy(np.diag([0.1 ** 2, 30.0 ** 2]))
    for z in zs:
        x, p = tkf.cubature_predict(x, p, lambda v: ft @ v, qt)
        x, p = tkf.cubature_update(torch.from_numpy(z), x, p, h, rt)
    with jax.enable_x64(True):
        jx = jnp.zeros(2)
        jp = jnp.asarray(np.diag([0.1 ** 2, 30.0 ** 2]))

        def jh(v):
            ang = 2.0 * jnp.pi * v[0]
            return jnp.stack([jnp.cos(ang), jnp.sin(ang)])
        pred = jax.jit(lambda a, b: jkf.cubature_predict(
            a, b, lambda v: jnp.asarray(f_mat) @ v, jnp.asarray(q)))
        upd = jax.jit(lambda zz, a, b: jkf.cubature_update(
            zz, a, b, jh, jnp.asarray(r)))
        for z in zs:
            jx, jp = pred(jx, jp)
            jx, jp = upd(jnp.asarray(z), jx, jp)
        _close(x.numpy(), jx)
        _close(p.numpy(), jp, atol=1e-12)
    assert abs(float(x[1]) - true_f) < 0.5
    err = (float(x[0]) - (true_phi + true_f * 399 * dt) + 0.5) % 1.0 - 0.5
    assert abs(err) < 0.05


@pytest.mark.parametrize("kind", ["cubature", "unscented"])
def test_batched_bank_equals_loop_and_jax(kind):
    rng = np.random.default_rng(11)
    c, nx, ny = 5, 3, 2
    f_mat = rng.uniform(0.1, 1.0, (nx, nx))
    h_mat = rng.uniform(0.1, 1.0, (ny, nx))
    xs = rng.standard_normal((c, nx))
    ps = np.stack([np.diag(rng.uniform(0.5, 2.0, nx)) for _ in range(c)])
    qs = np.stack([np.diag(rng.uniform(0.1, 0.5, nx)) for _ in range(c)])
    rs = np.stack([np.diag(rng.uniform(0.2, 0.5, ny)) for _ in range(c)])
    zs = rng.standard_normal((c, ny))
    tp, tu = (getattr(tkf, f"{kind}_predict"), getattr(tkf, f"{kind}_update"))
    ft, ht = torch.from_numpy(f_mat), torch.from_numpy(h_mat)
    f = lambda v: ft @ v                                  # noqa: E731
    h = lambda v: torch.sin(ht @ v)                       # noqa: E731
    t = [torch.from_numpy(a) for a in (xs, ps, qs, rs, zs)]
    xp_b, pp_b = tkf.batched_predict(tp)(t[0], t[1], f, t[2])
    xu_b, pu_b = tkf.batched_update(tu)(t[4], xp_b, pp_b, h, t[3])
    for i in range(c):
        xp, pp = tp(t[0][i], t[1][i], f, t[2][i])
        xu, pu = tu(t[4][i], xp, pp, h, t[3][i])
        for got, want in ((xp_b[i], xp), (pu_b[i], pu), (xu_b[i], xu)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-10)
    with jax.enable_x64(True):
        jp, ju = (getattr(jkf, f"{kind}_predict"),
                  getattr(jkf, f"{kind}_update"))
        jxp, jpp = jkf.batched_predict(jp)(
            jnp.asarray(xs), jnp.asarray(ps),
            lambda v: jnp.asarray(f_mat) @ v, jnp.asarray(qs))
        jxu, jpu = jkf.batched_update(ju)(
            jnp.asarray(zs), jxp, jpp,
            lambda v: jnp.sin(jnp.asarray(h_mat) @ v), jnp.asarray(rs))
        for got, want in ((xp_b, jxp), (pp_b, jpp), (xu_b, jxu),
                          (pu_b, jpu)):
            _close(got.numpy(), want, atol=1e-9)
