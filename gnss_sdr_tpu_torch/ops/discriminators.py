"""Tracking-loop discriminators (plain tensor functions, batched over channels).

Same estimator family as the reference's
``src/algorithms/tracking/libs/tracking_discriminators.cc`` — DLL non-coherent
early-minus-late power envelope, Costas PLL atan, FLL atan2 over consecutive
prompts — as float32 tensor ops on a leading channel axis.

The arctangent is :func:`atan32`, written out: the JAX reference's CPU
backend computes ``jnp.arctan`` of float32 as ``atan2(x, 1)``, a call to the
C library's ``atanf`` (bit for bit, over 10^7 random inputs), whose float32
polynomial differs from ``torch.atan`` on ~4 % of inputs (and from CUDA's
``atanf`` too), enough to turn a carrier frequency by an ulp. The Costas
discriminator's division by 2 pi is a multiply by its float32 reciprocal,
as that backend rewrites it (and as PyTorch's CUDA division by a number
computes it). The FLL's complex product keeps PyTorch's rounding, not the
backend's two FMAs (a c + b d, b c - a d): see
tests/test_torch_tracking.py. The fused tracking kernel computes the same
functions (csrc/tracking.cu).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops.correlator import const

_TWO_PI = float(np.float32(2.0 * np.pi))
_INV_TWO_PI = float(np.float32(1.0 / _TWO_PI))
_EPS = float(np.float32(1e-20))

# atan32's tables, by reduction interval (-1: |x| < 7/16, then 0-3): the
# reduced argument is (p |x| - q) / (r + s |x|), and atan(x) = hi - ((x' s
# - lo) - x') on it (hi = lo = 0 on interval -1, where the form is exact: it
# is x' - x' s); the bounds are the float32 words of 7/16, 11/16, 19/16 and
# 39/16
_ATAN_BOUNDS = (0x3EE00000, 0x3F300000, 0x3F980000, 0x401C0000)
_ATAN_PQRS = ((1.0, 0.0, 1.0, 0.0), (2.0, 1.0, 2.0, 1.0),
              (1.0, 1.0, 1.0, 1.0), (1.0, 1.5, 1.0, 1.5),
              (0.0, 1.0, 0.0, 1.0))
_ATAN_HI = (0.0, 4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (0.0, 5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_ATAN_T = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
           -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
           6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
           -3.6531571299e-02, 1.6285819933e-02)
_ATAN_HUGE = 33554432.0     # 2^25: atan is pi/2 in float32 from here on
_ATAN_PI_2 = float(np.float32(_ATAN_HI[4]) + np.float32(_ATAN_LO[4]))


@functools.lru_cache(maxsize=8)
def _atan_tables(device) -> tuple:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(_ATAN_BOUNDS, dtype=torch.int32, device=device),
            torch.tensor(_ATAN_PQRS, **f32), torch.tensor(_ATAN_HI, **f32),
            torch.tensor(_ATAN_LO, **f32))


@functools.lru_cache(maxsize=16)
def _atan_pairs(device, ndim: int) -> tuple:
    """atan32's polynomial coefficients as Horner pairs (even half, odd
    half) on a new leading axis before ``ndim`` broadcast ones: (a8, a7),
    (a10, a9), (a6, a5), (a4, a3), (a2, a1)."""
    order = ((8, 7), (10, 9), (6, 5), (4, 3), (2, 1))
    return tuple(torch.tensor([_ATAN_T[i], _ATAN_T[j]], dtype=torch.float32,
                              device=device).view(2, *(1,) * ndim)
                 for i, j in order)


def atan32(x: torch.Tensor) -> torch.Tensor:
    """float32 arctangent with the bits of the C library's ``atanf`` that
    the JAX reference's CPU backend calls (fdlibm's ``__atanf``, as glibc
    2.36 builds it): each float32 operation below rounds once, in fdlibm's
    order. Argument reduction of |x| to one of five intervals, an odd
    polynomial of degree 23 in two halves (s1 + s2), the sign put back."""
    bounds, pqrs, hi, lo = _atan_tables(x.device)
    ax = torch.abs(x)
    k = torch.bucketize(ax.view(torch.int32), bounds, right=True)
    p, q, r, s = pqrs[k].unbind(-1)
    t = (p * ax - q) / (r + s * ax)
    z = t * t
    w = z * z
    # the two halves' Horner steps side by side: (a8 + w a10, a7 + w a9),
    # then (a6, a5), (a4, a3), (a2, a1) + w times the step before, each
    # element through fdlibm's operations; the even half's last step alone
    pairs = _atan_pairs(x.device, x.ndim)
    h = pairs[0] + w * pairs[1]
    for c in pairs[2:]:
        h = c + w * h
    s1 = z * (const(_ATAN_T[0], x) + w * h[0])
    s2 = w * h[1]
    y = hi[k] - ((t * (s1 + s2) - lo[k]) - t)
    y = torch.where(ax >= const(_ATAN_HUGE, x), const(_ATAN_PI_2, x), y)
    return torch.copysign(y, x)


def dll_nc_vemlp(very_early, early, late, very_late) -> torch.Tensor:
    """VEML power discriminator for BOC signals (chips)."""
    p_e = torch.sqrt(torch.abs(very_early) ** 2 + torch.abs(early) ** 2)
    p_l = torch.sqrt(torch.abs(very_late) ** 2 + torch.abs(late) ** 2)
    return (p_e - p_l) / torch.clamp(p_e + p_l, min=_EPS)


def pll_atan2(prompt: torch.Tensor) -> torch.Tensor:
    """Four-quadrant phase discriminator (pilot channels), cycles."""
    return torch.atan2(prompt.imag, prompt.real) / _TWO_PI


def loop_discriminators(early: torch.Tensor, late: torch.Tensor,
                        prompt: torch.Tensor, prev_prompt: torch.Tensor,
                        dt_s: torch.Tensor, spacing_chips: float):
    """The tracking step's discriminators on [C] complex inputs ->
    (code_err, phase_err, freq_err, |prev_prompt|), each element through
    the JAX package's ``dll_nc_emlp``, ``pll_costas`` and ``fll_atan2``
    operations (so the same bits), the like operations of the three
    stacked: one magnitude pass for |E|, |L| and |P_{k-1}|, one guarded
    division and one :func:`atan32` for the Costas and FLL arguments.

    - code_err [chips]: the normalized non-coherent early-minus-late power
      (|E| - |L|) / (|E| + |L|) * (1 - spacing) (reference:
      dll_nc_e_minus_l_normalized, tracking_discriminators.cc).
    - phase_err [cycles]: the Costas atan(Q / I) / (2 pi), insensitive to
      data bits; the division by 2 pi a multiply by its float32
      reciprocal, as XLA rewrites a division by a constant (and PyTorch's
      CUDA division by a number does).
    - freq_err [Hz]: atan(cross / dot) / (2 pi dt) over consecutive
      prompts, dot + j cross = P_k conj(P_{k-1}): the atan (not atan2)
      form is insensitive to data-bit flips between the two prompts;
      pull-in range +/- 1 / (4 dt) Hz, positive when the true carrier is
      above the NCO.
    """
    mag = torch.abs(torch.stack([early, late, prev_prompt]))
    e, l, prev_abs = mag.unbind(0)
    eps = const(_EPS, e)
    code_err = (e - l) / torch.clamp(e + l, min=eps) * const(
        float(np.float32(1.0 - spacing_chips)), e)
    z = prompt * torch.conj(prev_prompt)
    # (Q / I, cross / dot), each denominator kept off zero
    num = torch.stack([prompt.imag, z.imag])
    den = torch.stack([prompt.real, z.real])
    den = torch.where(torch.abs(den) < eps, eps, den)
    at = atan32(num / den)
    phase_err = at[0] * const(_INV_TWO_PI, e)
    freq_err = at[1] / (const(_TWO_PI, e) * dt_s)
    return code_err, phase_err, freq_err, prev_abs
