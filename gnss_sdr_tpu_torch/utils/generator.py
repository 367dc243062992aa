"""Synthetic multi-satellite GNSS baseband signal generator (test fixture).

The analog of the reference's software signal generator
(``src/algorithms/signal_generator/gnuradio_blocks/signal_generator_c.cc``) and
of the external gnss-sim used by its system tests: synthesizes baseband IQ for
a set of satellites with known code delay, Doppler, C/N0 and data bits — the
ground truth that closed-loop tests assert against.

Physically consistent code Doppler: the code rate is scaled by
(1 + doppler/f_carrier) so carrier and code dynamics match, as for a real SV.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.models import codes


@dataclasses.dataclass
class SatParams:
    """Truth parameters for one simulated satellite signal."""

    prn: int
    cn0_dbhz: float = 45.0
    doppler_hz: float = 0.0
    doppler_rate_hz_s: float = 0.0
    code_delay_s: float = 0.0        # signal transmit delay at t=0 (s)
    data_bits: np.ndarray | None = None   # +/-1 per bit period; None = all +1
    carrier_phase_cycles: float = 0.0
    # cubic carrier-trajectory term (Hz/s^2): lets scenario builders fit
    # t_tx(t) with a cubic instead of a quadratic, cutting the cm-level
    # phase drift vs the true orbits that otherwise floors carrier-based
    # positioning tests (PPP-AR / RTK) at ~dm; 0 = legacy quadratic model
    doppler_jerk_hz_s2: float = 0.0


def _pm(seq) -> np.ndarray:
    """0/1 or +-1 sequence -> +-1 float64 chips."""
    a = np.asarray(seq, np.float64)
    return 1.0 - 2.0 * a if a.min() >= 0.0 else a


def _gen_block(spec, sats, fs, if_freq_hz, n0: int, n: int,
               with_pilot: bool = False, apply_secondary: bool = True,
               device="cpu") -> np.ndarray:
    """Signal (no noise) for samples [n0, n0+n), float64 time base.

    apply_secondary: modulate the data component with spec.secondary_code
    (NH/CS overlay, one chip per primary code period), as the real signals
    do. with_pilot: additionally emit the pilot component (same per-component
    C/N0) with its own code and secondary (E1-C/CS25, E5a-Q/CS100, L5Q).

    Phases (carrier + code) are tracked in float64 — the code delay needs
    ~ns resolution over minutes of signal — but the carrier is synthesized
    with float32 sincos after a mod-1 range reduction of the float64 cycle
    count: the residual angle error (~2^-24 cycles) is far below the noise
    floor, and float32 sincos is an order of magnitude cheaper than the
    complex128 ``np.exp`` it replaces. The sum runs on the torch
    ``device``: a wideband capture of minutes of several satellites takes
    the host minutes, the card seconds.
    """
    f64 = torch.float64
    t = (n0 + torch.arange(n, dtype=f64, device=device)) / fs
    out_i = torch.zeros(n, dtype=torch.float32, device=device)
    out_q = torch.zeros(n, dtype=torch.float32, device=device)
    fc = spec.carrier_freq_hz
    periods_per_bit = max(1, int(round(
        spec.bit_period_ms / (spec.code_length_chips / spec.code_rate_cps * 1e3))))

    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    for sp in sats:
        chips = dev32(codes.code_chips(spec.signal, sp.prn))
        lc = chips.shape[0]
        phase = (sp.carrier_phase_cycles + sp.doppler_hz * t
                 + 0.5 * sp.doppler_rate_hz_s * t * t
                 + sp.doppler_jerk_hz_s2 / 6.0 * t * t * t)
        # code phase integrates the same instantaneous Doppler as the carrier:
        # d(chip_phase)/dt = R * (1 + (doppler + rate*t)/fc)
        chip_phase = (t - sp.code_delay_s + phase / fc
                      - sp.carrier_phase_cycles / fc) * spec.code_rate_cps
        chip_idx = torch.floor(chip_phase).to(torch.int64)
        period_idx = torch.div(chip_idx, lc, rounding_mode="floor")  # period
        code = chips[torch.remainder(chip_idx, lc)]
        if spec.subcarrier_rate_hz > 0:
            sub_idx = torch.remainder(torch.floor(
                2.0 * chip_phase * spec.subcarrier_rate_hz
                / spec.code_rate_cps).to(torch.int64), 2)
            sub = (1.0 - 2.0 * sub_idx).to(torch.float32)
            code = code * sub
        # BeiDou GEO satellites (PRN 1-5) transmit D2 with no NH overlay
        nh_free_geo = spec.system == "C" and sp.prn <= 5
        if apply_secondary and spec.secondary_code and not nh_free_geo:
            sec = dev32(_pm([int(b) for b in spec.secondary_code]))
            code = code * sec[torch.remainder(period_idx, sec.shape[0])]
        if sp.data_bits is not None:
            bits = dev32(sp.data_bits)
            bit_idx = torch.div(chip_idx, lc * periods_per_bit,
                                rounding_mode="floor")
            comp = code * bits[torch.remainder(bit_idx, bits.shape[0])]
        else:
            comp = code
        amp = float(np.float32(np.sqrt(10.0 ** (sp.cn0_dbhz / 10.0) / fs)))
        if with_pilot and codes.has_pilot(spec.signal):
            pchips = dev32(codes.pilot_code_chips(spec.signal, sp.prn))
            pcode = pchips[torch.remainder(chip_idx, pchips.shape[0])]
            if spec.subcarrier_rate_hz > 0:
                pcode = pcode * sub
            psec = codes.pilot_secondary_chips(spec.signal, sp.prn)
            if psec is not None:
                psec = dev32(_pm(psec))
                pcode = pcode * psec[torch.remainder(period_idx,
                                                     psec.shape[0])]
            comp = comp + pcode
        # carrier: float64 cycles -> fractional cycle -> float32 sincos
        cyc = if_freq_hz * t + phase
        theta = ((cyc - torch.floor(cyc)) * (2.0 * np.pi)).to(torch.float32)
        comp = comp * amp
        out_i += comp * torch.cos(theta)
        out_q += comp * torch.sin(theta)
    out = np.empty(n, dtype=np.complex64)
    out.real = out_i.cpu().numpy()
    out.imag = out_q.cpu().numpy()
    return out


def generate(spec: constants.SignalSpec, sats: list[SatParams], fs: float,
             duration_s: float, *, if_freq_hz: float = 0.0,
             noise: bool = True, seed: int = 0,
             dtype=np.complex64, block_s: float = 2.0,
             with_pilot: bool = False,
             apply_secondary: bool = True, device=None) -> np.ndarray:
    """Generate baseband IQ samples (block-wise to bound peak memory).

    Noise is complex white Gaussian with unit variance per sample, so a
    satellite at C/N0 gets amplitude A = sqrt(10^(cn0/10) / fs). The signal
    sum of each block is computed on the torch ``device`` (the CPU when
    None); the noise is the same numpy draw on every device.
    """
    n = int(round(fs * duration_s))
    out = np.empty(n, dtype=dtype)
    rng = np.random.default_rng(seed)
    block = int(fs * block_s)
    for n0 in range(0, n, block):
        nb = min(block, n - n0)
        x = _gen_block(spec, sats, fs, if_freq_hz, n0, nb, with_pilot,
                       apply_secondary, "cpu" if device is None else device)
        if noise:
            x = x + (rng.standard_normal(nb) + 1j * rng.standard_normal(nb)) / np.sqrt(2.0)
        out[n0:n0 + nb] = x.astype(dtype)
    return out


def lnav_bits_to_symbols(bits01: np.ndarray) -> np.ndarray:
    """Map 0/1 nav bits to +/-1 symbols (bit 0 -> +1, matching chip mapping)."""
    return (1.0 - 2.0 * np.asarray(bits01, dtype=np.float64))
