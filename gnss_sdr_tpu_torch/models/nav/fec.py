"""FEC primitives for nav-message decoding: K=7 r=1/2 Viterbi, CRC-24Q,
the Galileo I/NAV block interleaver (the port's copy of
gnss_sdr_tpu/models/nav/fec.py).

Reference analogs: ``viterbi_decoder.cc`` (telemetry_decoder/libs) and
libswiftcnav's ``viterbi27.c`` / ``edc.c``. Implemented as vectorized numpy —
symbol rates are 25-500 sps per channel, firmly host-side work (SURVEY §2.3
marks this "not perf-critical") — with a fully-vectorized trellis update.

Convolutional code: CCSDS/Galileo/GPS-CNAV standard K=7, rate 1/2,
polynomials G1 = 171 (octal), G2 = 133 (octal).
"""

from __future__ import annotations

import numpy as np

G1 = 0o171
G2 = 0o133
K = 7
NSTATES = 64


def _output_tables(invert_g2: bool = False):
    """Per-state/per-input expected symbol pairs."""
    out = np.zeros((NSTATES, 2, 2), np.int8)  # [state, input, (s1, s2)]
    for s in range(NSTATES):
        for b in (0, 1):
            reg = (b << 6) | s      # newest bit in MSB of the 7-bit window
            o1 = bin(reg & G1).count("1") & 1
            o2 = bin(reg & G2).count("1") & 1
            if invert_g2:
                o2 ^= 1
            out[s, b, 0] = o1
            out[s, b, 1] = o2
    return out


def conv_encode(bits: np.ndarray, invert_g2: bool = False,
                flush: bool = True) -> np.ndarray:
    """Encode 0/1 bits -> 2N (+12 tail) symbols."""
    bits = np.asarray(bits, np.int8)
    if flush:
        bits = np.concatenate([bits, np.zeros(K - 1, np.int8)])
    out = np.empty(2 * len(bits), np.int8)
    reg = 0
    for i, b in enumerate(bits):
        reg = ((reg >> 1) | (int(b) << 6)) & 0x7F
        o1 = bin(reg & G1).count("1") & 1
        o2 = bin(reg & G2).count("1") & 1
        if invert_g2:
            o2 ^= 1
        out[2 * i] = o1
        out[2 * i + 1] = o2
    return out


def viterbi_decode(symbols: np.ndarray, n_bits: int,
                   invert_g2: bool = False) -> np.ndarray:
    """Soft-decision Viterbi decode.

    Args:
      symbols: [2*(n_bits (+6 if flushed))] soft symbols; sign convention
        +amp = bit 1, -amp = bit 0 (pass hard bits as +/-1).
      n_bits: number of information bits to return.
    Returns 0/1 uint8 array of length n_bits.
    """
    sym = np.asarray(symbols, np.float64)
    n_steps = len(sym) // 2
    out_tab = _output_tables(invert_g2).astype(np.float64) * 2.0 - 1.0

    # vectorized trellis: path metrics over 64 states. Uniform start metrics —
    # nav streams are decoded mid-stream (continuous FEC, unknown start state).
    pm = np.zeros(NSTATES)
    decisions = np.zeros((n_steps, NSTATES), np.uint8)
    states = np.arange(NSTATES)
    # transition: state s, input b -> next state ns = (s >> 1) | (b << 5)
    # equivalently: previous states of ns are p0 = (ns << 1) & 63 and p0 | 1
    prev0 = (states << 1) & 63
    prev1 = prev0 | 1
    # input bit implied at ns: b = ns >> 5
    b_of = states >> 5
    # branch metric uses the output of (prev_state, b)
    for t in range(n_steps):
        s1, s2 = sym[2 * t], sym[2 * t + 1]
        bm = out_tab[:, :, 0] * s1 + out_tab[:, :, 1] * s2  # [state, input]
        m0 = pm[prev0] + bm[prev0, b_of]
        m1 = pm[prev1] + bm[prev1, b_of]
        take1 = m1 > m0
        pm = np.where(take1, m1, m0)
        decisions[t] = take1

    # traceback from best final state
    s = int(np.argmax(pm))
    bits = np.zeros(n_steps, np.uint8)
    for t in range(n_steps - 1, -1, -1):
        bits[t] = s >> 5
        s = (s << 1) & 63 | int(decisions[t, s])
    return bits[:n_bits]


# ---------------------------------------------------------------------------
# CRC-24Q (RTCM / Galileo I/NAV / GPS CNAV; poly 0x1864CFB)
# ---------------------------------------------------------------------------

_CRC24Q_POLY = 0x1864CFB


def crc24q_bits(bits: np.ndarray) -> int:
    """CRC-24Q over a 0/1 bit array (MSB-first)."""
    crc = 0
    for b in np.asarray(bits, np.uint8):
        crc ^= int(b) << 23
        crc <<= 1
        if crc & 0x1000000:
            crc ^= _CRC24Q_POLY
        crc &= 0xFFFFFF
    return crc


def block_deinterleave(symbols: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Galileo I/NAV block deinterleaver: written column-wise (cols x rows),
    read row-wise on transmit -> receiver writes row-wise, reads column-wise."""
    return np.asarray(symbols).reshape(rows, cols).T.reshape(-1)


def block_interleave(symbols: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.asarray(symbols).reshape(cols, rows).T.reshape(-1)
