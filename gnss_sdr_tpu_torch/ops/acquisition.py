"""Batched PCPS (parallel code-phase search) acquisition.

Port of the JAX package's ``pcps_search`` / ``pcps_search_grids`` /
``fine_doppler_search`` (gnss_sdr_tpu/ops/acquisition.py:64-230) and of its
Galileo E5a ``noncoherent_iq_caf_search`` with ``caf_triangular_smooth``
(:409-520): the whole
[signal x doppler x code-phase] grid of the reference's
``pcps_acquisition.cc:633 acquisition_core`` as batched FFTs, with signals and
Doppler bins on the batch axes. The JAX package scans over signals to bound
memory; here signals are batched in groups sized to a fixed element budget.

Conventions match the reference so its config thresholds carry over:
  * ``max_power`` statistic  = |corr_peak|^2 / (N^2 * mean|x|^2)
    (pcps_acquisition::max_to_input_power_statistic with FFTW normalization
    folded in, pcps_acquisition.cc:529)
  * ``cfar`` statistic = first peak / second peak outside +/-1 chip, with
    circular code-phase distance (first_vs_second_peak_statistic,
    pcps_acquisition.cc:564)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import fft as fft_ops
from gnss_sdr_tpu_torch.ops import iq

_MINUS_TWO_PI = float(np.float32(-2.0 * np.pi))
# complex elements of one batched [S, B, D, N] correlation block
_BLOCK_ELEMS = 1 << 22


class AcqGridResult(NamedTuple):
    """Per-signal acquisition grid reduction results (leading axis = signal)."""

    test_max_power: torch.Tensor   # [S] max/input-power statistic
    test_cfar: torch.Tensor        # [S] first/second peak ratio
    code_phase: torch.Tensor       # [S] int32 sample index of peak (within code period)
    doppler_hz: torch.Tensor       # [S] float32 doppler of peak
    magnitude: torch.Tensor        # [S] raw |corr|^2 peak (FFTW-normalized)


def _dwell_windows(x: torch.Tensor, n_fft: int, noncoherent: int,
                   stride: int | None) -> torch.Tensor:
    """[noncoherent, n_fft] dwell windows from a flat sample vector.

    ``stride`` decouples the dwell advance from the (possibly
    friendly-padded, see ops/fft.friendly_len) FFT window: consecutive
    dwells start a code-period multiple apart so their correlation peaks
    land on the SAME lag and accumulate noncoherently."""
    if stride is None or stride == n_fft:
        return x[: noncoherent * n_fft].reshape(noncoherent, n_fft)
    return torch.stack([x[i * stride: i * stride + n_fft]
                        for i in range(noncoherent)])


def make_doppler_grid(doppler_max: float, doppler_step: float,
                      doppler_center: float = 0.0) -> np.ndarray:
    """Doppler bin centers, reference-compatible ordering (-max .. +max)."""
    n_bins = int(np.floor(2.0 * doppler_max / doppler_step)) + 1
    return (doppler_center - doppler_max
            + doppler_step * np.arange(n_bins)).astype(np.float32)


def _carriers(dopplers: torch.Tensor, n_fft: int, fs: float) -> torch.Tensor:
    """exp(-j 2 pi f t) wipe-off carriers, [..., D, N] complex64."""
    t = (torch.arange(n_fft, dtype=torch.float32, device=dopplers.device)
         * float(np.float32(1.0 / fs)))
    ang = (dopplers[..., :, None] * t) * _MINUS_TWO_PI
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _power(xf: torch.Tensor, cfc: torch.Tensor) -> torch.Tensor:
    """|IFFT(X * conj(C))|^2 summed over dwells: xf [S or 1, B, D, N],
    cfc [S, N] -> [S, D, N]."""
    corr = fft_ops.ifft(xf * cfc[:, None, None, :])
    return (torch.abs(corr) ** 2).sum(dim=1)


def _magnitudes(xf: torch.Tensor, cfc: torch.Tensor, n_fft: int) -> torch.Tensor:
    """:func:`_power`, FFTW-normalised."""
    return _power(xf, cfc) * float(np.float32(n_fft * n_fft))


def _row_peak(mag_cp: torch.Tensor, d_idx: torch.Tensor,
              samples_per_chip: int):
    """Peak, its code phase and the CFAR second peak of Doppler row
    ``d_idx`` of each [D, spc] grid in ``mag_cp`` [S, D, spc]: the peak is
    the row's first maximum (as ``jnp.argmax``), the second peak the row's
    largest cell at least ``samples_per_chip`` samples away in circular
    code-phase distance."""
    spc = mag_cp.shape[-1]
    row = mag_cp[torch.arange(mag_cp.shape[0], device=mag_cp.device), d_idx]
    t_idx = torch.argmax(row, dim=1)
    peak = torch.gather(row, 1, t_idx[:, None])[:, 0]
    pos = torch.arange(spc, device=mag_cp.device)
    dist = torch.abs(pos[None, :] - t_idx[:, None])
    dist = torch.minimum(dist, spc - dist)
    second = torch.where(dist >= samples_per_chip, row,
                         torch.zeros((), dtype=row.dtype, device=row.device)
                         ).amax(dim=1)
    return peak, t_idx, second


def _peaks(mag: torch.Tensor, samples_per_code: int, samples_per_chip: int):
    """Peak and CFAR second peak of each [D, N] grid in ``mag`` [S, D, N],
    in the Doppler row of the grid's first maximum (:func:`_row_peak`)."""
    mag_cp = mag[..., :samples_per_code]
    flat_idx = torch.argmax(mag_cp.reshape(mag_cp.shape[0], -1), dim=1)
    d_idx = torch.div(flat_idx, samples_per_code, rounding_mode="floor")
    peak, t_idx, second = _row_peak(mag_cp, d_idx, samples_per_chip)
    return peak, d_idx, t_idx, second


def _signal_block(n_dwell: int, n_dop: int, n_fft: int) -> int:
    return max(1, _BLOCK_ELEMS // (n_dwell * n_dop * n_fft))


def _result(peaks, t_idxs, seconds, dops_pk, xb, noncoherent: int,
            n_fft: int, components: int = 1) -> AcqGridResult:
    input_power = torch.mean(torch.abs(xb) ** 2) * float(noncoherent)
    if components > 1:
        # the input power counts every combined component
        input_power = input_power * float(components)
    nrm = float(np.float32(n_fft) ** 4)
    return AcqGridResult(
        test_max_power=(peaks / nrm / input_power).to(torch.float32),
        test_cfar=(peaks / torch.clamp(seconds, min=1e-30)).to(torch.float32),
        code_phase=t_idxs.to(torch.int32),
        doppler_hz=dops_pk.to(torch.float32),
        magnitude=peaks.to(torch.float32),
    )


def pcps_search(x: torch.Tensor, code_fft_conj: torch.Tensor,
                dopplers: torch.Tensor, *, fs: float, samples_per_code: int,
                samples_per_chip: int, noncoherent: int = 1,
                stride: int | None = None) -> AcqGridResult:
    """Run the full PCPS grid for a batch of signals on one shared grid.

    Args:
      x: [noncoherent * n_fft, 2] float32 split-IQ input samples (complex64,
        int8 and packed-nibble also accepted, see ops/iq.py).
      code_fft_conj: [S, n_fft, 2] float32 split conj(FFT(zero-padded local
        code)); complex64 also accepted.
      dopplers: [D] float32 Doppler bins (Hz).
      fs: sample rate (Hz).
      samples_per_code: length of one code period in samples (<= n_fft).
      samples_per_chip: CFAR exclusion half-width (samples).
      noncoherent: number of accumulated dwells.

    Returns AcqGridResult with statistics per signal.
    """
    x = iq.as_complex(x)
    cfc = iq.as_complex(code_fft_conj)
    n_fft = cfc.shape[-1]
    xb = _dwell_windows(x, n_fft, noncoherent, stride)
    xf = fft_ops.fft(xb[:, None, :] * _carriers(dopplers, n_fft, fs)[None])
    block = _signal_block(xb.shape[0], dopplers.shape[0], n_fft)
    parts = [_peaks(_magnitudes(xf[None], cfc[s0: s0 + block], n_fft),
                    samples_per_code, samples_per_chip)
             for s0 in range(0, cfc.shape[0], block)]
    peaks, d_idxs, t_idxs, seconds = (torch.cat(p) for p in zip(*parts))
    return _result(peaks, t_idxs, seconds, dopplers[d_idxs], xb, noncoherent,
                   n_fft)


def pcps_search_grids(x: torch.Tensor, code_fft_conj: torch.Tensor,
                      dopplers_sd: torch.Tensor, *, fs: float,
                      samples_per_code: int, samples_per_chip: int,
                      noncoherent: int = 1, stride: int | None = None
                      ) -> AcqGridResult:
    """PCPS with a PER-SIGNAL Doppler grid in one batched call (assisted
    acquisition around predicted Dopplers; reference
    ``pcps_assisted_acquisition_cc``).

    Args:
      x: [noncoherent * n_fft, 2] float32 split-IQ input (complex64 ok).
      code_fft_conj: [S, n_fft, 2] split conj(FFT(code)) per signal.
      dopplers_sd: [S, D] float32 Doppler bins, one row per signal.

    Returns AcqGridResult ([S] leaves); doppler_hz is in the grid's frame.
    """
    x = iq.as_complex(x)
    cfc = iq.as_complex(code_fft_conj)
    n_fft = cfc.shape[-1]
    xb = _dwell_windows(x, n_fft, noncoherent, stride)
    block = _signal_block(xb.shape[0], dopplers_sd.shape[1], n_fft)
    parts = []
    for s0 in range(0, cfc.shape[0], block):
        dops = dopplers_sd[s0: s0 + block]                        # [s, D]
        xf = fft_ops.fft(xb[None, :, None, :]
                         * _carriers(dops, n_fft, fs)[:, None])     # [s,B,D,N]
        peak, d_idx, t_idx, second = _peaks(
            _magnitudes(xf, cfc[s0: s0 + block], n_fft),
            samples_per_code, samples_per_chip)
        dop_pk = dops[torch.arange(dops.shape[0], device=dops.device), d_idx]
        parts.append((peak, t_idx, second, dop_pk))
    peaks, t_idxs, seconds, dops_pk = (torch.cat(p) for p in zip(*parts))
    return _result(peaks, t_idxs, seconds, dops_pk, xb, noncoherent, n_fft)


def caf_triangular_smooth(v: torch.Tensor, caf_bins_half: int) -> torch.Tensor:
    """Triangular-weighted Doppler smoothing of per-bin peak magnitudes.

    The reference's CAF filter (galileo_e5a_noncoherent_iq_acquisition_caf_
    cc.cc:611-697): each Doppler bin is replaced by the average of its
    +-caf_bins_half neighbours under weights w(k) = 1 - |k| / (2 * H),
    normalized by the weight mass actually inside the vector. Secondary-code
    sign flips split the E5a correlation peak into Doppler sidelobes; the
    smoothing re-centres the maximum on the true Doppler.

    Args:
      v: [..., D] per-Doppler peak magnitudes.
      caf_bins_half: H (CAF_window_hz / (2 * doppler_step) in the reference).
    """
    if caf_bins_half <= 0:
        return v
    h = int(caf_bins_half)
    wf = 0.5 / float(h)
    w = torch.from_numpy(
        (1.0 - wf * np.abs(np.arange(-h, h + 1))).astype(np.float32)
    ).to(v.device)                                            # [2H+1]
    d = v.shape[-1]
    # the window around each bin; out-of-range neighbours get weight 0
    idx = (torch.arange(d, device=v.device)[:, None]
           + torch.arange(-h, h + 1, device=v.device)[None, :])   # [D, 2H+1]
    inside = (idx >= 0) & (idx < d)
    vals = v[..., torch.clamp(idx, 0, d - 1)]               # [..., D, 2H+1]
    wm = w[None, :] * inside.to(torch.float32)
    return torch.sum(vals * wm, dim=-1) / torch.sum(wm, dim=-1)


def noncoherent_iq_caf_search(x: torch.Tensor, code_fft_conj_data: torch.Tensor,
                              code_fft_conj_pilot: torch.Tensor,
                              dopplers: torch.Tensor, *, fs: float,
                              samples_per_code: int, samples_per_chip: int,
                              noncoherent: int = 1, caf_bins_half: int = 0,
                              both_components: bool = True,
                              stride: int | None = None) -> AcqGridResult:
    """Galileo E5a noncoherent I/Q acquisition with optional CAF filtering
    (galileo_e5a_noncoherent_iq_acquisition_caf_cc).

    The E5a-I (data) and E5a-Q (pilot) components are correlated separately
    and combined NONcoherently per grid cell (``both_components``); with
    ``caf_bins_half > 0`` the per-Doppler peak magnitudes are triangularly
    smoothed over Doppler and the Doppler is re-selected from the smoothed
    vector, resolving the ambiguity the secondary-code sign transitions
    create. Code phase, peak and second peak come from the selected Doppler
    row of the combined grid.

    Shapes as :func:`pcps_search`, one code-FFT stack per component.
    """
    xc = iq.as_complex(x)
    cd = iq.as_complex(code_fft_conj_data)
    cp = iq.as_complex(code_fft_conj_pilot)
    n_fft = cd.shape[-1]
    xb = _dwell_windows(xc, n_fft, noncoherent, stride)
    xf = fft_ops.fft(xb[:, None, :] * _carriers(dopplers, n_fft, fs)[None])
    block = _signal_block(xb.shape[0], dopplers.shape[0], n_fft)
    nrm2 = float(np.float32(n_fft * n_fft))
    parts = []
    for s0 in range(0, cd.shape[0], block):
        mag = _power(xf[None], cd[s0: s0 + block])
        if both_components:
            mag = mag + _power(xf[None], cp[s0: s0 + block])
        mag = mag * nrm2
        if caf_bins_half > 0:
            caf = mag[..., :samples_per_code].amax(dim=2)            # [s, D]
            d_sel = torch.argmax(caf_triangular_smooth(caf, caf_bins_half),
                                 dim=1)
            # code phase / peak / second peak all from the SELECTED row, so
            # the reported triple stays consistent when smoothing moves it
            peak, t_idx, second = _row_peak(mag[..., :samples_per_code],
                                            d_sel, samples_per_chip)
        else:
            peak, d_sel, t_idx, second = _peaks(mag, samples_per_code,
                                                samples_per_chip)
        parts.append((peak, t_idx, second, dopplers[d_sel]))
    peaks, t_idxs, seconds, dops_pk = (torch.cat(p) for p in zip(*parts))
    return _result(peaks, t_idxs, seconds, dops_pk, xb, noncoherent, n_fft,
                   components=2 if both_components else 1)


def fine_doppler_search(x: torch.Tensor, code_replica: torch.Tensor,
                        dopplers: torch.Tensor, *, fs: float) -> torch.Tensor:
    """Step-two fine-Doppler refinement at a fixed code phase: [D] powers of
    the code-wiped input correlated against a fine Doppler grid (the
    reference's ``d_step_two`` path, pcps_acquisition.cc:772).

    Args:
      x: [N, 2] float32 split-IQ samples aligned so the code starts at
        sample 0 (complex64 also accepted).
      code_replica: [N] float32 sampled local code.
      dopplers: [D] float32 fine Doppler bins.
    """
    x = iq.as_complex(x)
    wiped = x * code_replica
    corr = _carriers(dopplers, x.shape[0], fs) @ wiped
    return torch.abs(corr) ** 2


def simple_threshold_from_pfa(pfa: float, n_cells: int, n_fft: int) -> float:
    """Exponential-cell CFAR threshold for the max/power statistic."""
    lam = -np.log(max(1.0 - (1.0 - pfa) ** (1.0 / float(n_cells)), 1e-300))
    return float(2.0 * lam / n_fft)
