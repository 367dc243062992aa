"""Batched Kalman-filter carrier tracking (phase / Doppler / Doppler rate).

Port of gnss_sdr_tpu/ops/kalman.py (reference analog:
``gps_l1_ca_kf_tracking_cc`` and the Bayesian measurement-covariance
machinery in ``src/algorithms/tracking/libs/bayesian_estimation.cc``). The
measurement model is linear (Costas phase error = phase state + noise), so
the exact linear KF is the optimal filter, batched as an error-state
filter: all channels advance together, the state covariances are a
``[C, 3, 3]`` tensor in the tracking carry, and the update has no
per-channel control flow.

Error-state convention: after every update the estimated phase error is
transferred into the NCO (a phase jump) and the Doppler estimate becomes
the NCO rate, so the carried mean reduces to the Doppler-rate state ``a``;
the predicted phase error over an interval dt is a dt^2 / 2.

Measurement noise R adapts to the C/N0 estimate (atan discriminator
variance 1 / (2 C/N0 T) rad^2), the reference's adaptive covariance in
closed form.

Numerics: the functions round as the JAX reference's CPU backend rounds
them inside its compiled tracking step, so the tracking loop keeps its
bits (tests/test_torch_kalman.py holds both against JAX bit for bit):

* ``10 ** x`` is the C library's ``powf`` (glibc's table-driven powf, which
  that backend calls), written out in float64 as :func:`pow32`;
  ``torch.pow`` differs from it on ~2 % of inputs;
* a division by a constant is a multiply by its float32 reciprocal;
* the backend contracts each single-use product into the sum that takes
  it: the 3 x 3 products accumulate as FMAs in index order, the process
  noise joins the predicted covariance's diagonal as FMAs
  (``dt q + p``), the predicted frequency is ``fma(a, dt, f)``, and the
  rate and frequency innovations fold the predicted phase's last product
  into the subtraction (``fma(-(a/2 dt), dt, e)``); the phase estimate's
  innovation, whose predicted phase has two uses, is rounded first.

:func:`~gnss_sdr_tpu_torch.ops.correlator.fma32` stands for the FMA (a
float64 product and sum rounded once: fmaf but on a double-rounding tie).
The fused tracking kernel computes the same operations
(csrc/tracking.cu ``kf_step``).
"""

from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops.correlator import const, fma32

# 1 / (4 pi^2) as the backend's reciprocal of the float32 4 pi^2
_INV_TWO_PI_SQ = float(np.float32(1.0) / np.float32(4.0 * np.pi ** 2))
_TENTH = float(np.float32(0.1))     # x / 10 -> x * float32(0.1)

# glibc's powf tables (sysdeps/ieee754/flt-32/e_powf_log2_data.c,
# e_exp2f_data.c): log2(c) near 16 subinterval centres c with 1/c, the
# log1p polynomial, and 2^(i/32) as double words less i << 47
_POWF_INVC = (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010bp+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8eap+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aap-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1")
_POWF_LOGC = (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7afp-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2")
_POWF_A = ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
           "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
           "0x1.71547652ab82bp+0")
EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
# exp2's rounding shift 0x1.8p52 / 32 and its cubic's coefficients
EXP2F_SHIFT = float.fromhex("0x1.8p+47")
EXP2F_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))


def powf_log2(x: float) -> float:
    """log2 of the float32 ``x`` (positive, normal) as glibc's powf takes
    it (``log2_inline``: a table entry and a degree-5 polynomial, in
    float64, each operation rounded)."""
    ix = struct.unpack("<I", struct.pack("<f", x))[0]
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) % 16
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = (top - (1 << 32) if top >= 1 << 31 else top) >> 23
    invc = float.fromhex(_POWF_INVC[i])
    logc = float.fromhex(_POWF_LOGC[i])
    a = [float.fromhex(h) for h in _POWF_A]
    z = struct.unpack("<f", struct.pack("<I", iz))[0]
    r = z * invc - 1.0
    y0 = logc + float(k)
    r2 = r * r
    y = a[0] * r + a[1]
    p = a[2] * r + a[3]
    r4 = r2 * r2
    q = a[4] * r + y0
    q = p * r2 + q
    return y * r4 + q


@functools.lru_cache(maxsize=8)
def _exp2_table(device) -> torch.Tensor:
    return torch.tensor(EXP2F_TAB, dtype=torch.int64, device=device)


def pow32(x: float, y: torch.Tensor) -> torch.Tensor:
    """float32 ``x ** y`` as the C library's ``powf`` computes it (glibc
    2.28+, which the JAX reference's CPU backend calls for ``jnp.power``):
    y log2(x) in float64, then 2^(k/32) from a table times a cubic in the
    remainder, rounded once to float32. ``x`` is a positive normal float32
    number; ``y`` a float32 tensor with |y log2 x| < 126 (no overflow or
    underflow path). Bit for bit with powf but on a float64 rounding tie
    (glibc may fuse some of the float64 products; that moves the float64
    result by ~1e-16, which reaches the float32 rounding about once in
    2^29)."""
    logx = const(powf_log2(float(np.float32(x))), y, torch.float64)
    ylogx = y.double() * logx
    shift = const(EXP2F_SHIFT, ylogx)
    kd = (ylogx + shift) - shift
    r = ylogx - kd
    k = (kd * const(32.0, kd)).to(torch.int64)
    s = (_exp2_table(y.device)[k & 31] + (k << 47)).view(torch.float64)
    c0, c1, c2 = (const(c, r) for c in EXP2F_C)
    z = c0 * r + c1
    r2 = r * r
    p = c2 * r + const(1.0, r)
    return ((z * r2 + p) * s).to(torch.float32)


def kf_init_cov(n_channels: int, sigma_phase_cyc: float = 0.1,
                sigma_freq_hz: float = 20.0,
                sigma_rate_hz_s: float = 20.0) -> np.ndarray:
    """Initial [C, 3, 3] covariance (host numpy, lives in the scan carry)."""
    p = np.zeros((n_channels, 3, 3), np.float32)
    p[:, 0, 0] = sigma_phase_cyc ** 2
    p[:, 1, 1] = sigma_freq_hz ** 2
    p[:, 2, 2] = sigma_rate_hz_s ** 2
    return p


def phase_meas_var_cyc2(cn0_dbhz: torch.Tensor,
                        coh_time_s: torch.Tensor) -> torch.Tensor:
    """Costas/atan discriminator variance in cycles^2 at given C/N0, T."""
    f = cn0_dbhz
    cn0 = pow32(10.0, torch.clamp(f, const(10.0, f), const(60.0, f))
                * const(_TENTH, f))
    two_snr = cn0 * coh_time_s * const(2.0, f)
    var_rad2 = (const(1.0, f) / two_snr + const(1.0, f)) / two_snr
    return var_rad2 * const(_INV_TWO_PI_SQ, f)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[C, 3, 3] a @ b, each entry's three products accumulated in index
    order, the second and third as FMAs."""
    m = a[:, :, 0, None] * b[:, None, 0, :]
    for j in (1, 2):
        m = fma32(a[:, :, j, None], b[:, None, j, :], m)
    return m


def kf_update(p: torch.Tensor, accel: torch.Tensor, freq: torch.Tensor,
              phase_err_cyc: torch.Tensor, dt: torch.Tensor,
              r_cyc2: torch.Tensor, *, q_phase: float = 1e-6,
              q_freq: float = 1.0, q_rate: float = 100.0):
    """One predict+update step for all channels.

    Args:
      p: [C, 3, 3] covariance.
      accel: [C] Doppler rate estimate (Hz/s).
      freq: [C] current NCO frequency (Hz, IF+Doppler).
      phase_err_cyc: [C] measured phase error (cycles).
      dt: [C] update interval (s).
      r_cyc2: [C] measurement variance (cycles^2).
      q_*: process noise densities per second (cycles^2/s, Hz^2/s,
        (Hz/s)^2/s).

    Returns (p_new, freq_new, accel_new, phase_corr_cyc): the NCO should add
    ``phase_corr_cyc`` to its phase and run at ``freq_new``.
    """
    dt = dt.to(torch.float32)
    half = const(0.5, dt)
    one, zero = torch.ones_like(dt), torch.zeros_like(dt)
    # F = [[1, dt, dt^2/2], [0, 1, dt], [0, 0, 1]]  (per channel)
    h = dt * half * dt
    f_mat = torch.stack([torch.stack([one, dt, h], -1),
                         torch.stack([zero, one, dt], -1),
                         torch.stack([zero, zero, one], -1)], -2)
    p_pred = _mm3(_mm3(f_mat, p), f_mat.transpose(1, 2))
    # + Q on the diagonal (dt * 1: an add)
    q_dt = torch.stack([fma32(dt, const(float(np.float32(q_phase)), dt),
                              p_pred[:, 0, 0]),
                        p_pred[:, 1, 1] + dt * const(float(np.float32(q_freq)),
                                                      dt),
                        fma32(dt, const(float(np.float32(q_rate)), dt),
                              p_pred[:, 2, 2])], -1)
    p_pred = p_pred.clone()
    p_pred.diagonal(dim1=1, dim2=2).copy_(q_dt)

    # predicted error-state mean: phase = a dt^2 / 2, freq = f + a dt
    a_half_dt = accel * half * dt
    phi_pred = a_half_dt * dt
    f_pred = fma32(accel, dt, freq)

    s = p_pred[:, 0, 0] + r_cyc2
    k = p_pred[:, :, 0] / s[:, None]                     # [C, 3]
    y = phase_err_cyc - phi_pred
    y_fused = fma32(-a_half_dt, dt, phase_err_cyc)
    phi_hat = fma32(k[:, 0], y, phi_pred)
    f_hat = fma32(k[:, 1], y_fused, f_pred)
    a_hat = fma32(k[:, 2], y_fused, accel)

    # P = (I - K H) P_pred, H = [1, 0, 0]
    ikh = torch.eye(3, dtype=p.dtype, device=p.device)[None].expand(
        k.shape[0], 3, 3).clone()
    ikh[:, :, 0] = ikh[:, :, 0] - k
    p_new = _mm3(ikh, p_pred)
    # keep symmetric against float32 roundoff
    p_new = (p_new + p_new.transpose(1, 2)) * half
    return p_new, f_hat, a_hat, phi_hat
