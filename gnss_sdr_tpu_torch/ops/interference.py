"""Interference suppression ops: pulse blanking and spectral notch excision.

Port of gnss_sdr_tpu/ops/interference.py (reference analogs:
``Pulse_Blanking_Filter`` (pulse_blanking_cc.cc) and ``Notch_Filter`` /
``Notch_Filter_Lite`` (notch_cc.cc)). Both are stateless per block and run as
plain PyTorch on the tensor's device: narrowband interference is excised in
the frequency domain (``torch.fft``, cuFFT on the card, where the JAX package
builds its FFT from DFT matmuls), and pulse blanking zeroes whole segments
whose mean power stands above the block's median segment power. Neither is a
Pallas kernel in the JAX package (XLA code under ``jit``).

Split-IQ float32 ``[N, 2]`` in and out (complex also accepted), as there.
"""

from __future__ import annotations

import torch

from gnss_sdr_tpu_torch.ops import iq


def median(v: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D float tensor as ``jnp.median`` takes it: the mean of
    the two middle values for an even length, ``(lo + hi) * 0.5``
    (``torch.median`` returns the lower one)."""
    s = torch.sort(v).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def pulse_blank_mask(x: torch.Tensor, threshold: float = 10.0,
                     window: int = 64) -> torch.Tensor:
    """[n // window] bool: the ``window``-sample segments whose mean |x|^2
    exceeds ``threshold`` times the median segment power."""
    z = iq.as_complex(x)
    n = (z.shape[0] // window) * window
    p = torch.abs(z[:n].reshape(-1, window)) ** 2
    seg_power = p.mean(dim=1)                        # [n / window]
    return seg_power > threshold * median(seg_power)


def pulse_blanking(x: torch.Tensor, threshold: float = 10.0,
                   window: int = 64) -> torch.Tensor:
    """Zero out samples inside high-power pulses: every segment of
    :func:`pulse_blank_mask`. The tail that does not fill a segment passes
    unblanked."""
    z = iq.as_complex(x)
    n = (z.shape[0] // window) * window
    if n == 0:
        return iq.as_iq2(z)
    mask = torch.repeat_interleave(~pulse_blank_mask(z, threshold, window),
                                   window)
    out = z[:n] * mask.to(z.dtype)
    return iq.as_iq2(torch.cat([out, z[n:]]))


def _notch_keep(spec: torch.Tensor, threshold_db: float) -> torch.Tensor:
    p = torch.abs(spec) ** 2
    limit = median(p) * torch.tensor(10.0 ** (threshold_db / 10.0),
                                     dtype=torch.float32, device=p.device)
    return p < limit


def notch_keep_mask(x: torch.Tensor, threshold_db: float = 12.0
                    ) -> torch.Tensor:
    """[N] bool: the FFT bins :func:`notch_excision` keeps, those whose
    power is below the median bin power times ``10^(threshold_db / 10)``."""
    return _notch_keep(torch.fft.fft(iq.as_complex(x).to(torch.complex64)),
                       threshold_db)


def notch_excision(x: torch.Tensor, threshold_db: float = 12.0) -> torch.Tensor:
    """Frequency-domain excision of narrowband (CW) interference: FFT the
    block, null every bin :func:`notch_keep_mask` does not keep, inverse
    FFT."""
    spec = torch.fft.fft(iq.as_complex(x).to(torch.complex64))
    keep = _notch_keep(spec, threshold_db)
    return iq.as_iq2(torch.fft.ifft(spec * keep.to(spec.dtype)))
