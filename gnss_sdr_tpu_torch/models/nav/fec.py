"""CRC-24Q (RTCM 3 framing; poly 0x1864CFB).

The part of gnss_sdr_tpu/models/nav/fec.py that the port's RTCM encoder
needs (the Viterbi decoder and interleavers serve signals not ported yet).
"""

from __future__ import annotations

import numpy as np

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
