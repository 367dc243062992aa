"""LAMBDA integer least-squares ambiguity resolution.

The port's copy of gnss_sdr_tpu/receiver/pvt/lambda_ilsq.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: ``src/algorithms/libs/rtklib/rtklib_lambda.cc`` (RTKLIB's
port of the Delft LAMBDA method): L^T D L decomposition of the float
ambiguity covariance, integer Z-transform decorrelation (lambda_reduction),
and a Schnorr-Euchner depth-first integer search returning the two best
candidates for the ratio test. Host numpy float64 — runs once per epoch on a
handful of ambiguities, nothing to accelerate.
"""

from __future__ import annotations

import numpy as np


def _ltdl(q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q = L^T diag(d) L with unit lower-triangular L (RTKLIB LD())."""
    n = q.shape[0]
    a = q.copy().astype(np.float64)
    l_mat = np.zeros((n, n))
    d = np.zeros(n)
    for i in range(n - 1, -1, -1):
        d[i] = a[i, i]
        if d[i] <= 0:
            raise np.linalg.LinAlgError("covariance not positive definite")
        l_mat[i, : i + 1] = a[i, : i + 1] / np.sqrt(d[i])
        for j in range(i):
            a[j, : j + 1] -= l_mat[i, : j + 1] * l_mat[i, j]
        l_mat[i, : i + 1] /= l_mat[i, i]
    return l_mat, d


def _reduction(l_mat: np.ndarray, d: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lambda decorrelation: integer Gauss transforms + symmetric
    permutations (RTKLIB reduction()/gauss()/perm())."""
    n = len(d)
    l_mat = l_mat.copy()
    d = d.copy()
    z = np.eye(n)
    j = n - 2
    k = n - 2
    while j >= 0:
        if j <= k:
            for i in range(j + 1, n):      # integer Gauss on column j
                mu = round(l_mat[i, j])
                if mu != 0:
                    l_mat[i:, j] -= mu * l_mat[i:, i]
                    z[:, j] -= mu * z[:, i]
        delta = d[j] + l_mat[j + 1, j] ** 2 * d[j + 1]
        if delta + 1e-6 < d[j + 1]:        # permute columns j, j+1
            eta = d[j] / delta
            lam = d[j + 1] * l_mat[j + 1, j] / delta
            d[j] = eta * d[j + 1]
            d[j + 1] = delta
            a0 = l_mat[j, :j].copy()
            a1 = l_mat[j + 1, :j].copy()
            l_mat[j, :j] = -l_mat[j + 1, j] * a0 + a1
            l_mat[j + 1, :j] = eta * a0 + lam * a1
            l_mat[j + 1, j] = lam
            l_mat[j + 2:, [j, j + 1]] = l_mat[j + 2:, [j + 1, j]]
            z[:, [j, j + 1]] = z[:, [j + 1, j]]
            k = j
            j = n - 2
        else:
            j -= 1
    return l_mat, d, z


def _search(l_mat: np.ndarray, d: np.ndarray, zs: np.ndarray,
            n_cands: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Schnorr-Euchner integer search (RTKLIB search()).

    Returns (candidates [m, n], squared norms [m]) sorted best-first.
    """
    n = len(d)
    chi2 = 1e18
    cands: list[tuple[float, np.ndarray]] = []
    dist = np.zeros(n)
    zb = np.zeros(n)
    z_int = np.zeros(n)
    step = np.zeros(n)

    k = n - 1
    zb[k] = zs[k]
    z_int[k] = round(zb[k])
    y = zb[k] - z_int[k]
    step[k] = np.sign(y) if y != 0 else 1.0
    s = np.zeros((n, n))
    it = 0
    while it < 100000:
        it += 1
        newdist = dist[k] + y * y / d[k]
        if newdist < chi2:
            if k != 0:
                dist[k - 1] = newdist
                s[k - 1, :k] = s[k, :k] + (z_int[k] - zb[k]) * l_mat[k, :k]
                k -= 1
                zb[k] = zs[k] + s[k, k]
                z_int[k] = round(zb[k])
                y = zb[k] - z_int[k]
                step[k] = np.sign(y) if y != 0 else 1.0
            else:
                cands.append((newdist, z_int.copy()))
                cands.sort(key=lambda t: t[0])
                if len(cands) > n_cands:
                    cands.pop()
                if len(cands) == n_cands:
                    chi2 = cands[-1][0]
                z_int[0] += step[0]
                y = zb[0] - z_int[0]
                step[0] = -step[0] - np.sign(step[0])
        else:
            if k == n - 1:
                break
            k += 1
            z_int[k] += step[k]
            y = zb[k] - z_int[k]
            step[k] = -step[k] - np.sign(step[k])
    cands.sort(key=lambda t: t[0])
    m = len(cands)
    out = np.stack([c[1] for c in cands]) if m else np.zeros((0, n))
    norms = np.array([c[0] for c in cands])
    return out, norms


def lambda_ils(a_float: np.ndarray, q: np.ndarray, n_cands: int = 2
               ) -> tuple[np.ndarray, np.ndarray]:
    """Integer least-squares: argmin_z (a-z)^T Q^-1 (a-z).

    Args:
      a_float: [n] float ambiguity estimates.
      q: [n, n] their covariance.
    Returns (candidates [m, n] in the ORIGINAL basis best-first,
             squared norms [m]).
    """
    a_float = np.asarray(a_float, np.float64)
    n = len(a_float)
    if n == 0:
        return np.zeros((0, 0)), np.zeros(0)
    l_mat, d = _ltdl(q)
    l_red, d_red, z = _reduction(l_mat, d)
    zt_a = z.T @ a_float
    cands_z, norms = _search(l_red, d_red, zt_a, n_cands)
    if len(cands_z) == 0:
        return np.zeros((0, n)), norms
    zinv = np.linalg.inv(z.T)
    cands = np.stack([zinv @ c for c in cands_z])
    return np.round(cands), norms


def ratio_test(norms: np.ndarray, threshold: float = 3.0) -> bool:
    """Standard ambiguity validation: second-best / best >= threshold."""
    if len(norms) < 2 or norms[0] <= 0:
        return False
    return bool(norms[1] / max(norms[0], 1e-12) >= threshold)


def bootstrap_success_rate(q: np.ndarray) -> float:
    """Bootstrapped integer success rate P_s = prod(2*Phi(1/(2*sigma_i))-1)
    over the DECORRELATED conditional standard deviations (Teunissen 1998;
    rtklib's conffunc role). A lower bound on the ILS success rate that,
    unlike the ratio test, scales honestly with the covariance: sigma >=
    ~0.3 cycles on any component collapses P_s toward zero. Use as an AR
    gate: do not accept (or even attempt) a fix whose success rate says
    the data cannot support one."""
    import math

    q = np.asarray(q, np.float64)
    if q.size == 0:
        return 0.0
    l_mat, d = _ltdl(q)
    l_red, d_red, _z = _reduction(l_mat, d)
    p = 1.0
    for var in d_red:
        sig = math.sqrt(max(var, 1e-30))
        p *= max(2.0 * (0.5 * (1.0 + math.erf(1.0 / (2.0 * sig)
                                              / math.sqrt(2.0)))) - 1.0, 0.0)
    return float(p)
