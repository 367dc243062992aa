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
               with_pilot: bool = False,
               apply_secondary: bool = True) -> np.ndarray:
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
    complex128 ``np.exp`` it replaces (the 12 MSps L5 / 8 MSps FDMA system
    fixtures are generated on one host core).
    """
    t = (n0 + np.arange(n, dtype=np.float64)) / fs
    out_i = np.zeros(n, dtype=np.float32)
    out_q = np.zeros(n, dtype=np.float32)
    fc = spec.carrier_freq_hz
    periods_per_bit = max(1, int(round(
        spec.bit_period_ms / (spec.code_length_chips / spec.code_rate_cps * 1e3))))

    for sp in sats:
        chips = codes.code_chips(spec.signal, sp.prn).astype(np.float32)
        lc = len(chips)
        phase = (sp.carrier_phase_cycles + sp.doppler_hz * t
                 + 0.5 * sp.doppler_rate_hz_s * t * t
                 + sp.doppler_jerk_hz_s2 / 6.0 * t * t * t)
        # code phase integrates the same instantaneous Doppler as the carrier:
        # d(chip_phase)/dt = R * (1 + (doppler + rate*t)/fc)
        chip_phase = (t - sp.code_delay_s + phase / fc
                      - sp.carrier_phase_cycles / fc) * spec.code_rate_cps
        chip_idx = np.floor(chip_phase).astype(np.int64)
        period_idx = chip_idx // lc          # primary code period counter
        code = chips[chip_idx % lc]
        if spec.subcarrier_rate_hz > 0:
            sub_idx = np.floor(2.0 * chip_phase * spec.subcarrier_rate_hz
                               / spec.code_rate_cps).astype(np.int64) % 2
            sub = (1.0 - 2.0 * sub_idx).astype(np.float32)
            code = code * sub
        # BeiDou GEO satellites (PRN 1-5) transmit D2 with no NH overlay
        nh_free_geo = spec.system == "C" and sp.prn <= 5
        if apply_secondary and spec.secondary_code and not nh_free_geo:
            sec = _pm([int(b) for b in spec.secondary_code]).astype(np.float32)
            code = code * sec[period_idx % len(sec)]
        if sp.data_bits is not None:
            bits = np.asarray(sp.data_bits, dtype=np.float32)
            bit_idx = chip_idx // (lc * periods_per_bit)
            comp = code * bits[bit_idx % len(bits)]
        else:
            comp = code
        amp = np.float32(np.sqrt(10.0 ** (sp.cn0_dbhz / 10.0) / fs))
        if with_pilot and codes.has_pilot(spec.signal):
            pchips = codes.pilot_code_chips(spec.signal, sp.prn).astype(np.float32)
            pcode = pchips[chip_idx % len(pchips)]
            if spec.subcarrier_rate_hz > 0:
                pcode = pcode * sub
            psec = codes.pilot_secondary_chips(spec.signal, sp.prn)
            if psec is not None:
                psec = _pm(psec).astype(np.float32)
                pcode = pcode * psec[period_idx % len(psec)]
            comp = comp + pcode
        # carrier: float64 cycles -> fractional cycle -> float32 sincos
        cyc = if_freq_hz * t + phase
        theta = ((cyc - np.floor(cyc)) * (2.0 * np.pi)).astype(np.float32)
        comp *= amp
        out_i += comp * np.cos(theta)
        out_q += comp * np.sin(theta)
    out = np.empty(n, dtype=np.complex64)
    out.real = out_i
    out.imag = out_q
    return out


def generate(spec: constants.SignalSpec, sats: list[SatParams], fs: float,
             duration_s: float, *, if_freq_hz: float = 0.0,
             noise: bool = True, seed: int = 0,
             dtype=np.complex64, block_s: float = 2.0,
             with_pilot: bool = False,
             apply_secondary: bool = True) -> np.ndarray:
    """Generate baseband IQ samples (block-wise to bound peak memory).

    Noise is complex white Gaussian with unit variance per sample, so a
    satellite at C/N0 gets amplitude A = sqrt(10^(cn0/10) / fs).
    """
    n = int(round(fs * duration_s))
    out = np.empty(n, dtype=dtype)
    rng = np.random.default_rng(seed)
    block = int(fs * block_s)
    for n0 in range(0, n, block):
        nb = min(block, n - n0)
        x = _gen_block(spec, sats, fs, if_freq_hz, n0, nb,
                       with_pilot=with_pilot, apply_secondary=apply_secondary)
        if noise:
            x = x + (rng.standard_normal(nb) + 1j * rng.standard_normal(nb)) / np.sqrt(2.0)
        out[n0:n0 + nb] = x.astype(dtype)
    return out


def lnav_bits_to_symbols(bits01: np.ndarray) -> np.ndarray:
    """Map 0/1 nav bits to +/-1 symbols (bit 0 -> +1, matching chip mapping)."""
    return (1.0 - 2.0 * np.asarray(bits01, dtype=np.float64))
