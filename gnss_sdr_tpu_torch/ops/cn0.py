"""C/N0 estimation and lock detectors as exponential-smoother carry updates.

Reference analogs: ``cn0_svn_estimator`` and ``carrier_lock_detector`` in
``src/algorithms/tracking/libs/lock_detectors.cc``. Instead of the reference's
20-sample block buffers, the carry keeps exponentially smoothed moments —
O(1) state per channel, equivalent steady-state behavior.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops.correlator import const

_EPS = float(np.float32(1e-12))


class Cn0State(NamedTuple):
    ema_abs_i: torch.Tensor    # E[|I_P|]
    ema_p2: torch.Tensor       # E[|P|^2]
    ema_i2_minus_q2: torch.Tensor   # E[I^2 - Q^2]  (carrier lock metric num.)
    ema_i2_plus_q2: torch.Tensor    # E[I^2 + Q^2]  (carrier lock metric den.)


def cn0_update(state: Cn0State, prompt: torch.Tensor, valid: torch.Tensor,
               alpha: float = 0.05) -> Cn0State:
    """Update smoothed moments with the latest prompt correlator output.

    The JAX reference's CPU backend contracts ``i*i + q*q``, ``i*i - q*q``
    and ``old + a*(new - old)`` into FMAs (i*i fused, q*q rounded first);
    the port writes those roundings out, so on the same prompts the moments
    keep the reference's bits."""
    i = prompt.real
    q = prompt.imag
    qq = (q * q).double()
    ii = i.double() * i.double()            # exact in float64
    a = const(float(np.float32(alpha)), i, torch.float64)
    p2 = (ii + qq).to(torch.float32)
    # the four moments' fma32(a, new - old, old) in one pass
    old = torch.stack(list(state))
    new = torch.stack([torch.abs(i), p2, (ii - qq).to(torch.float32), p2])
    upd = (a * (new - old).double() + old.double()).to(torch.float32)
    return Cn0State(*torch.where(valid, upd, old).unbind(0))


def cn0_dbhz(state: Cn0State, coh_time_s: torch.Tensor) -> torch.Tensor:
    """Signal-to-Noise-Variance C/N0 estimate in dB-Hz.

    SNV: Pd = (E[|I|])^2 (signal power), Pn = E[|P|^2] - Pd (noise power);
    C/N0 = (Pd / Pn) / T_coh.
    """
    pd = state.ema_abs_i ** 2
    eps = const(_EPS, pd)
    pn = torch.clamp(state.ema_p2 - pd, min=eps)
    snr = pd / pn
    return const(10.0, pd) * torch.log10(torch.clamp(snr / coh_time_s,
                                                     min=eps))


def carrier_lock_metric(state: Cn0State) -> torch.Tensor:
    """Carrier lock test in [-1, 1]: cos(2*phase_err) estimate.

    > ~0.85 means solid phase lock (reference uses 0.85 via
    carrier_lock_detector with NBD/NBP).
    """
    den = state.ema_i2_plus_q2
    return state.ema_i2_minus_q2 / torch.clamp(den, min=const(_EPS, den))
