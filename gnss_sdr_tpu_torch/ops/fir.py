"""FIR filtering / resampling ops for the signal conditioner.

Port of gnss_sdr_tpu/ops/fir.py (reference analogs: the ``Fir_Filter``
adapter, ``Mmse_Resampler``, ``Direct_Resampler`` and the frequency
translation of ``Freq_Xlating_Fir_Filter``). Filter design is host-side numpy
(windowed sinc); application is plain PyTorch on the receiver's device,
streaming block by block with an overlap (state) tail so block boundaries
are seamless: the FIR as one ``conv1d`` over the I and Q lanes, the
fractional resampler as a gather of input windows and of rows of a
polyphase sinc bank followed by their product. Neither is a Pallas kernel in
the JAX package (``jnp.convolve`` under ``jax.vmap`` and a jitted gather).
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import iq
from gnss_sdr_tpu_torch.ops.correlator import fma32


def design_lowpass(num_taps: int, cutoff_norm: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass FIR. cutoff_norm = f_c / (fs/2) in (0, 1)."""
    if num_taps % 2 == 0:
        num_taps += 1
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff_norm * n) * cutoff_norm
    if window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(num_taps) / (num_taps - 1))
    elif window == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * np.arange(num_taps) / (num_taps - 1))
             + 0.08 * np.cos(4 * np.pi * np.arange(num_taps) / (num_taps - 1)))
    else:
        w = np.ones(num_taps)
    h = h * w
    return (h / h.sum()).astype(np.float32)


def _upload(x, device: torch.device) -> torch.Tensor:
    """A host block (complex or split-IQ) as float32 [N, 2] on ``device``."""
    return torch.from_numpy(iq.split(x)).to(device)


def fir_filter_chunk(x2: torch.Tensor, taps: torch.Tensor, tail: torch.Tensor,
                     decim: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter one block with carry-over state.

    Args:
      x2: [N, 2] float32 split-IQ new samples.
      taps: [T] float32 FIR taps.
      tail: [T-1, 2] float32 last samples of the previous block.
      decim: integer decimation factor.

    Returns (y, new_tail): y [ceil(N / decim), 2], the convolution (kernel
    reversed, as ``numpy.convolve``) at every ``decim``-th output.
    """
    t = taps.shape[0]
    xx = torch.cat([tail, x2]).t().unsqueeze(1)              # [2, 1, T-1+N]
    y = torch.nn.functional.conv1d(xx, taps.flip(0).view(1, 1, t),
                                   stride=decim)
    return y[:, 0].t().contiguous(), x2[-(t - 1):]


class StreamingFir:
    """Holds the overlap tail between blocks on ``device``."""

    def __init__(self, taps: np.ndarray, decim: int = 1, device="cpu"):
        self.device = torch.device(device)
        self.taps = torch.from_numpy(
            np.asarray(taps, np.float32).copy()).to(self.device)
        self.decim = decim
        self._tail = torch.zeros((len(taps) - 1, 2), dtype=torch.float32,
                                 device=self.device)

    def __call__(self, x) -> np.ndarray:
        y, self._tail = fir_filter_chunk(_upload(x, self.device), self.taps,
                                         self._tail, self.decim)
        return y.cpu().numpy()                # [M, 2] float32 split-IQ


def direct_resample(x: torch.Tensor, factor_num: int, factor_den: int,
                    n_out: int) -> torch.Tensor:
    """Nearest-sample resampler (reference Direct_Resampler): picks
    x[floor(k * den / num)] for k in [0, n_out), the indices in int64."""
    k = torch.arange(n_out, dtype=torch.int64, device=x.device)
    return x[torch.div(k * factor_den, factor_num, rounding_mode="floor")]


def freq_translate(x: torch.Tensor, f_shift_hz: float, fs: float,
                   n0: int = 0) -> torch.Tensor:
    """Frequency-translate a block (IF -> baseband) by exp(-j 2 pi f n / fs)
    with n = n0 + k, so successive blocks stay phase-continuous. The phase
    is taken in cycles in float64 and reduced modulo one cycle before the
    float32 ``exp``: exact at any n0 (the JAX package forms -2 pi f n / fs
    in float32 and loses the carrier once n reaches ~10^7). Split-IQ in and
    out."""
    z = iq.as_complex(x)
    r = f_shift_hz / fs
    base = (int(n0) * r) % 1.0
    cyc = base + torch.arange(z.shape[0], dtype=torch.float64,
                              device=z.device) * r
    cyc = cyc - torch.floor(cyc)
    ph = (cyc * (-2.0 * np.pi)).to(torch.float32)
    return iq.as_iq2(z * torch.polar(torch.ones_like(ph), ph))


# ---------------------------------------------------------------------------
# Fractional (MMSE) resampler — reference Mmse_Resampler
# ---------------------------------------------------------------------------


def _sinc_bank(n_phases: int = 128, n_taps: int = 8) -> np.ndarray:
    """Polyphase windowed-sinc interpolation bank [n_phases, n_taps]."""
    h = np.zeros((n_phases, n_taps), np.float32)
    center = n_taps // 2 - 1
    for ph in range(n_phases):
        mu = ph / n_phases
        t = np.arange(n_taps) - center - mu
        w = np.hamming(2 * n_taps)[n_taps // 2: n_taps // 2 + n_taps]
        h[ph] = (np.sinc(t) * w).astype(np.float32)
        h[ph] /= h[ph].sum()
    return h


def fractional_resample_chunk(x2: torch.Tensor, pos0: float, ratio: float,
                              bank: torch.Tensor, n_out_max: int
                              ) -> tuple[torch.Tensor, int]:
    """Polyphase sinc interpolation (reference Mmse_Resampler analog).

    Args:
      x2: [N, 2] float32 split-IQ input.
      pos0: fractional input position of output sample 0 (rounded to
        float32).
      ratio: input samples per output sample (rounded to float32).
      bank: [P, T] float32 polyphase filter bank (_sinc_bank()).
      n_out_max: output buffer length.

    Returns (y2 [n_out_max, 2], n_valid): entries past n_valid are zero.
    The positions are float32 ``pos0 + k * ratio`` with one rounding, as
    the JAX package's compiler fuses them on the CPU.
    """
    n_in = x2.shape[0]
    n_ph, n_taps = bank.shape
    center = n_taps // 2 - 1
    dev = x2.device
    k = torch.arange(n_out_max, dtype=torch.float32, device=dev)
    pos = fma32(k, torch.full_like(k, float(np.float32(ratio))),
                torch.full_like(k, float(np.float32(pos0))))
    base = torch.floor(pos).to(torch.int32)
    mu = pos - base.to(torch.float32)
    ph = torch.clamp((mu * n_ph).to(torch.int32), 0, n_ph - 1)
    valid = (base - center >= 0) & (base - center + n_taps <= n_in)
    n_valid = int(valid.sum())
    safe = torch.clamp(base - center, 0, max(n_in - n_taps, 0))
    idx = safe[:, None].long() + torch.arange(n_taps, device=dev)[None, :]
    taps = bank[ph.long()]                              # [M, T]
    win = x2[idx]                                       # [M, T, 2]
    y2 = torch.einsum("mt,mtc->mc", taps, win)
    y2 = y2 * valid[:, None].to(torch.float32)
    return y2, n_valid


class StreamingFractionalResampler:
    """Arbitrary fs_in -> fs_out over blocked input on ``device``
    (reference Mmse_Resampler adapter)."""

    def __init__(self, fs_in: float, fs_out: float, n_taps: int = 8,
                 device="cpu"):
        self.device = torch.device(device)
        self.ratio = fs_in / fs_out
        self.bank = torch.from_numpy(_sinc_bank(n_taps=n_taps)).to(self.device)
        self._tail = torch.zeros((0, 2), dtype=torch.float32,
                                 device=self.device)
        self._pos = float(n_taps)        # start clear of the left edge
        self.n_taps = n_taps

    def __call__(self, x) -> np.ndarray:
        x2 = torch.cat([self._tail, _upload(x, self.device)])
        n_in = len(x2)
        n_out_max = int(np.ceil(n_in / self.ratio)) + 2
        y2, n_valid = fractional_resample_chunk(
            x2, self._pos, self.ratio, self.bank, n_out_max)
        y = y2[:n_valid].cpu().numpy()
        # keep enough tail for the interpolation window, rebase position
        next_pos = self._pos + n_valid * self.ratio
        keep_from = max(0, int(np.floor(next_pos)) - self.n_taps)
        self._tail = x2[keep_from:]
        self._pos = next_pos - keep_from
        return y
