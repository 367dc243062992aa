"""Antenna-array beamformer (reference: Beamformer_Filter adapter,
``src/algorithms/input_filter/gnuradio_blocks/beamformer.cc``).

Port of gnss_sdr_tpu/ops/beamformer.py: a fixed complex weight vector
combines an N-element array stream, one ``[N] x [N, T]`` complex contraction
on the tensor's device; steering weights for a uniform linear array come
from the usual exp(-j pi k sin(theta)) model. Split-IQ float32 in and out.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import iq


def ula_steering_weights(n_elements: int, theta_rad: float,
                         spacing_wavelengths: float = 0.5) -> np.ndarray:
    """Phase-steering weights for a uniform linear array toward theta
    (broadside = 0); returns [N] complex64, unit per-element gain."""
    k = np.arange(n_elements)
    phase = -2.0 * np.pi * spacing_wavelengths * k * np.sin(theta_rad)
    return (np.exp(1j * phase) / n_elements).astype(np.complex64)


def beamform(x2: torch.Tensor, weights2: torch.Tensor) -> torch.Tensor:
    """Combine an [N, T, 2] split-IQ array stream with [N, 2] weights:
    y[t] = sum_n w[n] * x[n, t] (:func:`ula_steering_weights` already
    returns the conjugated steering vector). Returns [T, 2] float32."""
    x = iq.as_complex(x2)
    w = iq.as_complex(weights2).to(x.device)
    return iq.as_iq2(w @ x)
