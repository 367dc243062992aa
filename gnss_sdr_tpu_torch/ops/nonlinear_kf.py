"""Sigma-point (cubature / unscented) Kalman filters on tensors.

Port of gnss_sdr_tpu/ops/nonlinear_kf.py (reference analog:
``src/algorithms/tracking/libs/nonlinear_tracking.{h,cc}``, CubatureFilter /
UnscentedFilter, Arasaratnam & Haykin 2009, QA'd there by
``cubature_filter_test.cc`` / ``unscented_filter_test.cc`` against the exact
linear KF). The model is a callable on one state vector, mapped over the
sigma-point axis with ``torch.func.vmap``, so one filter step is a handful
of [P, N] matrix ops; a bank of filters (one per tracking channel) batches
with an outer ``vmap`` (:func:`batched_predict` / :func:`batched_update`).

The functions run on the device of their tensors and in their dtype (the
reference's alpha = 1e-3 gives unscented weights of ~1e6, so the linear
equivalence holds to float64 precision only). ``predict`` and ``update`` are
separate (the reference's predict_sequential / update_sequential) so callers
can interleave them with NCO feedback. The receiver does not reach them.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

Model = Callable[[torch.Tensor], torch.Tensor]


def _sqrt_cov(p: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD matrix square root via eigendecomposition (the
    reference's ``arma::sqrtmat_sympd``; a Cholesky factor would fail on the
    semidefinite covariances a strong update leaves)."""
    w, v = torch.linalg.eigh(p)
    w = torch.sqrt(torch.clamp(w, min=0.0))
    return (v * w[None, :]) @ v.T


def _cubature_points(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[2n, n] cubature point set: x +- sqrt(n) S e_i (3rd-degree rule)."""
    n = x.shape[0]
    s = _sqrt_cov(p) * torch.sqrt(torch.tensor(float(n), dtype=x.dtype,
                                               device=x.device))
    return torch.cat([x[None, :] + s.T, x[None, :] - s.T], dim=0)


def _solve_gain(s: torch.Tensor, pxz: torch.Tensor) -> torch.Tensor:
    """K = Pxz S^-1, solved (not inverted) on the [m, m] system."""
    return torch.linalg.solve(s.T, pxz.T).T


def cubature_predict(x: torch.Tensor, p: torch.Tensor, f: Model,
                     q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CKF time update: propagate the 2n cubature points through ``f``.

    Args:
      x: [n] posterior mean.   p: [n, n] posterior covariance.
      f: transition model, [n] -> [n] (mapped over the points).
      q: [n, n] process noise covariance.
    Returns (x_pred, p_pred).
    """
    pts = vmap(f)(_cubature_points(x, p))                # [2n, n]
    x_pred = pts.mean(dim=0)
    d = pts - x_pred[None, :]
    p_pred = d.T @ d / pts.shape[0] + q
    return x_pred, 0.5 * (p_pred + p_pred.T)


def cubature_update(z: torch.Tensor, x_pred: torch.Tensor,
                    p_pred: torch.Tensor, h: Model, r: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """CKF measurement update with measurement model ``h`` ([n] -> [m]).
    Returns (x_post, p_post)."""
    pts = _cubature_points(x_pred, p_pred)               # [2n, n]
    zs = vmap(h)(pts)                                    # [2n, m]
    z_pred = zs.mean(dim=0)
    dz = zs - z_pred[None, :]
    dx = pts - x_pred[None, :]
    npts = pts.shape[0]
    s = dz.T @ dz / npts + r                             # [m, m]
    pxz = dx.T @ dz / npts                               # [n, m]
    k = _solve_gain(s, pxz)                              # [n, m]
    x_post = x_pred + k @ (z - z_pred)
    p_post = p_pred - k @ s @ k.T
    return x_post, 0.5 * (p_post + p_post.T)


def _ut_weights(n: int, alpha: float, kappa: float, beta: float, like
                ) -> tuple[torch.Tensor, torch.Tensor, float]:
    lam = alpha * alpha * (n + kappa) - n
    wm = torch.full((2 * n + 1,), 1.0 / (2.0 * (n + lam)), dtype=like.dtype,
                    device=like.device)
    wc = wm.clone()
    wm[0] = lam / (n + lam)
    wc[0] = lam / (n + lam) + (1.0 - alpha * alpha + beta)
    return wm, wc, float(n + lam)


def _ut_points(x: torch.Tensor, p: torch.Tensor, scale: float
               ) -> torch.Tensor:
    """[2n+1, n] unscented point set: x, x +- sqrt(n + lambda) S e_i."""
    s = _sqrt_cov(p) * torch.sqrt(torch.tensor(scale, dtype=x.dtype,
                                               device=x.device))
    return torch.cat([x[None, :], x[None, :] + s.T, x[None, :] - s.T], dim=0)


def unscented_predict(x: torch.Tensor, p: torch.Tensor, f: Model,
                      q: torch.Tensor, *, alpha: float = 1e-3,
                      kappa: float = 0.0, beta: float = 2.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """UKF time update (reference defaults alpha=1e-3, kappa=0, beta=2,
    ``nonlinear_tracking.cc`` UnscentedFilter::predict_sequential)."""
    n = x.shape[0]
    wm, wc, scale = _ut_weights(n, alpha, kappa, beta, x)
    pts = vmap(f)(_ut_points(x, p, scale))               # [2n+1, n]
    x_pred = wm @ pts
    d = pts - x_pred[None, :]
    p_pred = (d * wc[:, None]).T @ d + q
    return x_pred, 0.5 * (p_pred + p_pred.T)


def unscented_update(z: torch.Tensor, x_pred: torch.Tensor,
                     p_pred: torch.Tensor, h: Model, r: torch.Tensor, *,
                     alpha: float = 1e-3, kappa: float = 0.0,
                     beta: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """UKF measurement update; weights as in the reference."""
    n = x_pred.shape[0]
    wm, wc, scale = _ut_weights(n, alpha, kappa, beta, x_pred)
    pts = _ut_points(x_pred, p_pred, scale)              # [2n+1, n]
    zs = vmap(h)(pts)                                    # [2n+1, m]
    z_pred = wm @ zs
    dz = zs - z_pred[None, :]
    dx = pts - x_pred[None, :]
    s = (dz * wc[:, None]).T @ dz + r
    pxz = (dx * wc[:, None]).T @ dz
    k = _solve_gain(s, pxz)
    x_post = x_pred + k @ (z - z_pred)
    p_post = p_pred - k @ s @ k.T
    return x_post, 0.5 * (p_post + p_post.T)


def batched_predict(step=cubature_predict) -> Callable:
    """Lift a predict step over a leading channel axis:
    (x[C,n], P[C,n,n], f, Q[C,n,n]) -> (x_pred[C,n], P_pred[C,n,n]), the
    channel-bank analog of the reference running one filter object per
    tracking channel."""
    def bank(x, p, f, q):
        return vmap(lambda xi, pi, qi: step(xi, pi, f, qi))(x, p, q)
    return bank


def batched_update(step=cubature_update) -> Callable:
    """Lift an update step over a leading channel axis:
    (z[C,m], x[C,n], P[C,n,n], h, R[C,m,m]) -> posterior bank."""
    def bank(z, x, p, h, r):
        return vmap(lambda zi, xi, pi, ri: step(zi, xi, pi, h, ri))(
            z, x, p, r)
    return bank
