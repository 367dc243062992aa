"""RTCM 3.x message encoder/decoder + TCP broadcast server.

The port's copy of gnss_sdr_tpu/receiver/pvt/rtcm.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: ``src/algorithms/PVT/libs/rtcm.cc`` (5.8 k LoC) and
``rtcm_printer.cc`` — the PVT block emits station reference (1005), broadcast
ephemerides (1019 GPS / 1045 Galileo) and MSM7 observables (1077 GPS /
1097 Galileo) over a TCP server. This implementation covers that emitted set
with both encode and decode (decode doubles as the QA oracle), on a plain
bit-cursor over numpy uint8 bits.

Framing: 0xD3 preamble, 6 reserved bits, 10-bit length, payload, CRC-24Q
(same polynomial as the nav CRC in models/nav/fec.py).
"""

from __future__ import annotations

import dataclasses
import socket
import threading

import numpy as np

from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import fec

PI = 3.1415926535898
SPEED_OF_LIGHT = 299_792_458.0
RANGE_MS = SPEED_OF_LIGHT * 1e-3          # one millisecond of range


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, value: int, n: int) -> None:
        v = int(value) & ((1 << n) - 1)
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def s(self, value: int, n: int) -> None:
        self.u(int(value) & ((1 << n) - 1), n)

    def sq(self, value: float, scale: float, n: int) -> None:
        """Signed quantized field."""
        self.s(int(round(value / scale)), n)

    def uq(self, value: float, scale: float, n: int) -> None:
        self.u(int(round(value / scale)), n)

    def smq(self, value: float, scale: float, n: int) -> None:
        """Sign-magnitude quantized field (GLONASS RTCM convention,
        DF105..DF136: MSB = sign, remaining n-1 bits = magnitude)."""
        v = int(round(abs(value) / scale))
        self.u((1 << (n - 1)) | v if value < 0 else v, n)

    def array(self) -> np.ndarray:
        return np.asarray(self.bits, np.uint8)


class BitReader:
    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, np.uint8)
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for b in self.bits[self.pos: self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def s(self, n: int) -> int:
        v = self.u(n)
        if v >= (1 << (n - 1)):
            v -= 1 << n
        return v

    def sq(self, scale: float, n: int) -> float:
        return self.s(n) * scale

    def uq(self, scale: float, n: int) -> float:
        return self.u(n) * scale

    def smq(self, scale: float, n: int) -> float:
        """Sign-magnitude quantized field (inverse of BitWriter.smq)."""
        v = self.u(n)
        mag = (v & ((1 << (n - 1)) - 1)) * scale
        return -mag if v >> (n - 1) else mag


def _bits_to_bytes(bits: np.ndarray) -> bytes:
    pad = (-len(bits)) % 8
    b = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return bytes(np.packbits(b))


def _bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8))


def frame(payload_bits: np.ndarray) -> bytes:
    """Wrap payload bits in an RTCM 3 frame (preamble, length, CRC-24Q)."""
    pad = (-len(payload_bits)) % 8
    payload_bits = np.concatenate(
        [payload_bits, np.zeros(pad, np.uint8)])
    n_bytes = len(payload_bits) // 8
    w = BitWriter()
    w.u(0xD3, 8)
    w.u(0, 6)
    w.u(n_bytes, 10)
    head_payload = np.concatenate([w.array(), payload_bits])
    crc = fec.crc24q_bits(head_payload)
    w2 = BitWriter()
    w2.u(crc, 24)
    return _bits_to_bytes(np.concatenate([head_payload, w2.array()]))


def deframe(data: bytes) -> list[np.ndarray]:
    """Extract CRC-valid payloads from a byte stream; returns payload bits."""
    out = []
    i = 0
    while i + 6 <= len(data):
        if data[i] != 0xD3:
            i += 1
            continue
        n = ((data[i + 1] & 0x03) << 8) | data[i + 2]
        end = i + 3 + n + 3
        if end > len(data):
            break
        bits = _bytes_to_bits(data[i: i + 3 + n])
        crc_rx = int.from_bytes(data[i + 3 + n: end], "big")
        if fec.crc24q_bits(bits) == crc_rx:
            out.append(bits[24:])
            i = end
        else:
            i += 1
    return out


def deframe_stream(data: bytes) -> tuple[list[np.ndarray], bytes]:
    """Incremental deframer: returns (payload bits, unconsumed tail).

    The tail holds a possibly-incomplete trailing frame so a TCP stream can
    be fed in arbitrary pieces without duplicating messages.
    """
    out = []
    i = 0
    while True:
        j = data.find(b"\xd3", i)
        if j < 0:
            return out, b""
        if j + 3 > len(data):
            return out, data[j:]
        n = ((data[j + 1] & 0x03) << 8) | data[j + 2]
        end = j + 3 + n + 3
        if end > len(data):
            return out, data[j:]
        bits = _bytes_to_bits(data[j: j + 3 + n])
        crc_rx = int.from_bytes(data[j + 3 + n: end], "big")
        if fec.crc24q_bits(bits) == crc_rx:
            out.append(bits[24:])
            i = end
        else:
            i = j + 1


def message_number(payload_bits: np.ndarray) -> int:
    return BitReader(payload_bits).u(12)


# ---------------------------------------------------------------------------
# 1005 — station antenna reference point
# ---------------------------------------------------------------------------


def encode_1005(station_id: int, ecef: np.ndarray, *,
                gps: bool = True, glo: bool = False, gal: bool = True
                ) -> np.ndarray:
    w = BitWriter()
    w.u(1005, 12)
    w.u(station_id, 12)
    w.u(0, 6)                      # ITRF realization year
    w.u(1 if gps else 0, 1)
    w.u(1 if glo else 0, 1)
    w.u(1 if gal else 0, 1)
    w.u(0, 1)                      # reference-station indicator
    w.sq(ecef[0], 1e-4, 38)
    w.u(0, 1)                      # single receiver oscillator
    w.u(0, 1)                      # reserved
    w.sq(ecef[1], 1e-4, 38)
    w.u(0, 2)                      # quarter cycle indicator
    w.sq(ecef[2], 1e-4, 38)
    return w.array()


def decode_1005(bits: np.ndarray) -> dict:
    r = BitReader(bits)
    assert r.u(12) == 1005
    station = r.u(12)
    r.u(6)
    gps, glo, gal = r.u(1), r.u(1), r.u(1)
    r.u(1)
    x = r.sq(1e-4, 38)
    r.u(2)
    y = r.sq(1e-4, 38)
    r.u(2)
    z = r.sq(1e-4, 38)
    return dict(station_id=station, ecef=np.array([x, y, z]),
                gps=bool(gps), glo=bool(glo), gal=bool(gal))


# ---------------------------------------------------------------------------
# 1019 (GPS) / 1045 (Galileo F/NAV) broadcast ephemeris
# ---------------------------------------------------------------------------

_SC = PI  # semicircle


def encode_1019(eph: KeplerEphemeris) -> np.ndarray:
    w = BitWriter()
    w.u(1019, 12)
    w.u(eph.prn, 6)
    w.u(eph.week % 1024, 10)
    w.u(eph.ura & 0xF, 4)
    w.u(0, 2)                                  # L2 code
    w.sq(eph.idot / _SC, 2.0 ** -43, 14)
    w.u(eph.iode & 0xFF, 8)
    w.uq(eph.toc, 16.0, 16)
    w.sq(eph.af2, 2.0 ** -55, 8)
    w.sq(eph.af1, 2.0 ** -43, 16)
    w.sq(eph.af0, 2.0 ** -31, 22)
    w.u(eph.iodc & 0x3FF, 10)
    w.sq(eph.crs, 2.0 ** -5, 16)
    w.sq(eph.delta_n / _SC, 2.0 ** -43, 16)
    w.sq(eph.m0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cuc, 2.0 ** -29, 16)
    w.uq(eph.e, 2.0 ** -33, 32)
    w.sq(eph.cus, 2.0 ** -29, 16)
    w.uq(eph.sqrt_a, 2.0 ** -19, 32)
    w.uq(eph.toe, 16.0, 16)
    w.sq(eph.cic, 2.0 ** -29, 16)
    w.sq(eph.omega0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cis, 2.0 ** -29, 16)
    w.sq(eph.i0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.crc, 2.0 ** -5, 16)
    w.sq(eph.omega / _SC, 2.0 ** -31, 32)
    w.sq(eph.omega_dot / _SC, 2.0 ** -43, 24)
    w.sq(eph.tgd, 2.0 ** -31, 8)
    w.u(eph.health & 0x3F, 6)
    w.u(0, 1)                                  # L2 P data flag
    w.u(0, 1)                                  # fit interval
    return w.array()


def decode_1019(bits: np.ndarray) -> KeplerEphemeris:
    r = BitReader(bits)
    assert r.u(12) == 1019
    e = KeplerEphemeris()
    e.prn = r.u(6)
    e.week = r.u(10)
    e.ura = r.u(4)
    r.u(2)
    e.idot = r.sq(2.0 ** -43, 14) * _SC
    e.iode = r.u(8)
    e.toc = r.uq(16.0, 16)
    e.af2 = r.sq(2.0 ** -55, 8)
    e.af1 = r.sq(2.0 ** -43, 16)
    e.af0 = r.sq(2.0 ** -31, 22)
    e.iodc = r.u(10)
    e.crs = r.sq(2.0 ** -5, 16)
    e.delta_n = r.sq(2.0 ** -43, 16) * _SC
    e.m0 = r.sq(2.0 ** -31, 32) * _SC
    e.cuc = r.sq(2.0 ** -29, 16)
    e.e = r.uq(2.0 ** -33, 32)
    e.cus = r.sq(2.0 ** -29, 16)
    e.sqrt_a = r.uq(2.0 ** -19, 32)
    e.toe = r.uq(16.0, 16)
    e.cic = r.sq(2.0 ** -29, 16)
    e.omega0 = r.sq(2.0 ** -31, 32) * _SC
    e.cis = r.sq(2.0 ** -29, 16)
    e.i0 = r.sq(2.0 ** -31, 32) * _SC
    e.crc = r.sq(2.0 ** -5, 16)
    e.omega = r.sq(2.0 ** -31, 32) * _SC
    e.omega_dot = r.sq(2.0 ** -43, 24) * _SC
    e.tgd = r.sq(2.0 ** -31, 8)
    e.health = r.u(6)
    return e


def encode_1044(eph: KeplerEphemeris) -> np.ndarray:
    """QZSS ephemeris (MT1044, rtklib decode_type1044 layout): GPS LNAV
    scalings, 4-bit satellite id = PRN - 192, clock block leading."""
    w = BitWriter()
    w.u(1044, 12)
    w.u(eph.prn - 192, 4)
    w.uq(eph.toc, 16.0, 16)
    w.sq(eph.af2, 2.0 ** -55, 8)
    w.sq(eph.af1, 2.0 ** -43, 16)
    w.sq(eph.af0, 2.0 ** -31, 22)
    w.u(eph.iode & 0xFF, 8)
    w.sq(eph.crs, 2.0 ** -5, 16)
    w.sq(eph.delta_n / _SC, 2.0 ** -43, 16)
    w.sq(eph.m0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cuc, 2.0 ** -29, 16)
    w.uq(eph.e, 2.0 ** -33, 32)
    w.sq(eph.cus, 2.0 ** -29, 16)
    w.uq(eph.sqrt_a, 2.0 ** -19, 32)
    w.uq(eph.toe, 16.0, 16)
    w.sq(eph.cic, 2.0 ** -29, 16)
    w.sq(eph.omega0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cis, 2.0 ** -29, 16)
    w.sq(eph.i0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.crc, 2.0 ** -5, 16)
    w.sq(eph.omega / _SC, 2.0 ** -31, 32)
    w.sq(eph.omega_dot / _SC, 2.0 ** -43, 24)
    w.sq(eph.idot / _SC, 2.0 ** -43, 14)
    w.u(0, 2)                                  # L2 code
    w.u(eph.week % 1024, 10)
    w.u(eph.ura & 0xF, 4)
    w.u(eph.health & 0x3F, 6)
    w.sq(eph.tgd, 2.0 ** -31, 8)
    w.u(eph.iodc & 0x3FF, 10)
    w.u(0, 1)                                  # fit interval (0 = 2 h)
    return w.array()


def decode_1044(bits: np.ndarray) -> KeplerEphemeris:
    r = BitReader(bits)
    assert r.u(12) == 1044
    e = KeplerEphemeris()
    e.prn = r.u(4) + 192
    e.toc = r.uq(16.0, 16)
    e.af2 = r.sq(2.0 ** -55, 8)
    e.af1 = r.sq(2.0 ** -43, 16)
    e.af0 = r.sq(2.0 ** -31, 22)
    e.iode = r.u(8)
    e.crs = r.sq(2.0 ** -5, 16)
    e.delta_n = r.sq(2.0 ** -43, 16) * _SC
    e.m0 = r.sq(2.0 ** -31, 32) * _SC
    e.cuc = r.sq(2.0 ** -29, 16)
    e.e = r.uq(2.0 ** -33, 32)
    e.cus = r.sq(2.0 ** -29, 16)
    e.sqrt_a = r.uq(2.0 ** -19, 32)
    e.toe = r.uq(16.0, 16)
    e.cic = r.sq(2.0 ** -29, 16)
    e.omega0 = r.sq(2.0 ** -31, 32) * _SC
    e.cis = r.sq(2.0 ** -29, 16)
    e.i0 = r.sq(2.0 ** -31, 32) * _SC
    e.crc = r.sq(2.0 ** -5, 16)
    e.omega = r.sq(2.0 ** -31, 32) * _SC
    e.omega_dot = r.sq(2.0 ** -43, 24) * _SC
    e.idot = r.sq(2.0 ** -43, 14) * _SC
    r.u(2)
    e.week = r.u(10)
    e.ura = r.u(4)
    e.health = r.u(6)
    e.tgd = r.sq(2.0 ** -31, 8)
    e.iodc = r.u(10)
    return e


def encode_1045(eph: KeplerEphemeris) -> np.ndarray:
    """Galileo F/NAV ephemeris (same Kepler set, Galileo scalings)."""
    w = BitWriter()
    w.u(1045, 12)
    w.u(eph.prn, 6)
    w.u(eph.week % 4096, 12)
    w.u(eph.iode & 0x3FF, 10)
    w.u(eph.ura & 0xFF, 8)                     # SISA
    w.sq(eph.idot / _SC, 2.0 ** -43, 14)
    w.uq(eph.toc, 60.0, 14)
    w.sq(eph.af2, 2.0 ** -59, 6)
    w.sq(eph.af1, 2.0 ** -46, 21)
    w.sq(eph.af0, 2.0 ** -34, 31)
    w.sq(eph.crs, 2.0 ** -5, 16)
    w.sq(eph.delta_n / _SC, 2.0 ** -43, 16)
    w.sq(eph.m0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cuc, 2.0 ** -29, 16)
    w.uq(eph.e, 2.0 ** -33, 32)
    w.sq(eph.cus, 2.0 ** -29, 16)
    w.uq(eph.sqrt_a, 2.0 ** -19, 32)
    w.uq(eph.toe, 60.0, 14)
    w.sq(eph.cic, 2.0 ** -29, 16)
    w.sq(eph.omega0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cis, 2.0 ** -29, 16)
    w.sq(eph.i0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.crc, 2.0 ** -5, 16)
    w.sq(eph.omega / _SC, 2.0 ** -31, 32)
    w.sq(eph.omega_dot / _SC, 2.0 ** -43, 24)
    w.sq(eph.tgd, 2.0 ** -32, 10)              # BGD E1/E5a
    w.u(eph.health & 0x3, 2)                   # E5a HS
    w.u(0, 1)                                  # E5a DVS
    w.u(0, 7)                                  # reserved
    return w.array()


def decode_1045(bits: np.ndarray) -> KeplerEphemeris:
    from gnss_sdr_tpu_torch import constants
    r = BitReader(bits)
    assert r.u(12) == 1045
    e = KeplerEphemeris()
    e.prn = r.u(6)
    e.week = r.u(12)
    e.iode = r.u(10)
    e.ura = r.u(8)
    e.idot = r.sq(2.0 ** -43, 14) * _SC
    e.toc = r.uq(60.0, 14)
    e.af2 = r.sq(2.0 ** -59, 6)
    e.af1 = r.sq(2.0 ** -46, 21)
    e.af0 = r.sq(2.0 ** -34, 31)
    e.crs = r.sq(2.0 ** -5, 16)
    e.delta_n = r.sq(2.0 ** -43, 16) * _SC
    e.m0 = r.sq(2.0 ** -31, 32) * _SC
    e.cuc = r.sq(2.0 ** -29, 16)
    e.e = r.uq(2.0 ** -33, 32)
    e.cus = r.sq(2.0 ** -29, 16)
    e.sqrt_a = r.uq(2.0 ** -19, 32)
    e.toe = r.uq(60.0, 14)
    e.cic = r.sq(2.0 ** -29, 16)
    e.omega0 = r.sq(2.0 ** -31, 32) * _SC
    e.cis = r.sq(2.0 ** -29, 16)
    e.i0 = r.sq(2.0 ** -31, 32) * _SC
    e.crc = r.sq(2.0 ** -5, 16)
    e.omega = r.sq(2.0 ** -31, 32) * _SC
    e.omega_dot = r.sq(2.0 ** -43, 24) * _SC
    e.tgd = r.sq(2.0 ** -32, 10)
    e.health = r.u(2)
    e.gm = constants.GM_EARTH_GAL
    return e


def encode_1046(eph: KeplerEphemeris, bgd_e5b: float = 0.0,
                e5b_health: int = 0, e1b_health: int = 0) -> np.ndarray:
    """Galileo I/NAV ephemeris (RTCM 10403.3 MT1046).

    Same Kepler set as 1045 but carrying BOTH broadcast group delays
    (BGD E1/E5a in ``eph.tgd`` — the I/NAV telemetry convention here,
    models/nav/galileo_inav.py — plus BGD E1/E5b) and the E5b + E1-B
    health/validity flags. The reference consumes this via rtklib's
    ``decode_type1046`` (rtklib_rtcm3.cc:1765); note that that decoder
    predates the final layout and stops after the first BGD.
    """
    w = BitWriter()
    w.u(1046, 12)
    w.u(eph.prn, 6)
    w.u(eph.week % 4096, 12)
    w.u(eph.iode & 0x3FF, 10)
    w.u(eph.ura & 0xFF, 8)                     # SISA
    w.sq(eph.idot / _SC, 2.0 ** -43, 14)
    w.uq(eph.toc, 60.0, 14)
    w.sq(eph.af2, 2.0 ** -59, 6)
    w.sq(eph.af1, 2.0 ** -46, 21)
    w.sq(eph.af0, 2.0 ** -34, 31)
    w.sq(eph.crs, 2.0 ** -5, 16)
    w.sq(eph.delta_n / _SC, 2.0 ** -43, 16)
    w.sq(eph.m0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cuc, 2.0 ** -29, 16)
    w.uq(eph.e, 2.0 ** -33, 32)
    w.sq(eph.cus, 2.0 ** -29, 16)
    w.uq(eph.sqrt_a, 2.0 ** -19, 32)
    w.uq(eph.toe, 60.0, 14)
    w.sq(eph.cic, 2.0 ** -29, 16)
    w.sq(eph.omega0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cis, 2.0 ** -29, 16)
    w.sq(eph.i0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.crc, 2.0 ** -5, 16)
    w.sq(eph.omega / _SC, 2.0 ** -31, 32)
    w.sq(eph.omega_dot / _SC, 2.0 ** -43, 24)
    w.sq(eph.tgd, 2.0 ** -32, 10)              # BGD E1/E5a
    w.sq(bgd_e5b, 2.0 ** -32, 10)              # BGD E1/E5b
    w.u(e5b_health & 0x3, 2)
    w.u(0, 1)                                  # E5b DVS
    w.u(e1b_health & 0x3, 2)
    w.u(0, 1)                                  # E1-B DVS
    return w.array()


def decode_1046(bits: np.ndarray) -> tuple[KeplerEphemeris, dict]:
    from gnss_sdr_tpu_torch import constants
    r = BitReader(bits)
    assert r.u(12) == 1046
    e = KeplerEphemeris()
    e.prn = r.u(6)
    e.week = r.u(12)
    e.iode = r.u(10)
    e.ura = r.u(8)
    e.idot = r.sq(2.0 ** -43, 14) * _SC
    e.toc = r.uq(60.0, 14)
    e.af2 = r.sq(2.0 ** -59, 6)
    e.af1 = r.sq(2.0 ** -46, 21)
    e.af0 = r.sq(2.0 ** -34, 31)
    e.crs = r.sq(2.0 ** -5, 16)
    e.delta_n = r.sq(2.0 ** -43, 16) * _SC
    e.m0 = r.sq(2.0 ** -31, 32) * _SC
    e.cuc = r.sq(2.0 ** -29, 16)
    e.e = r.uq(2.0 ** -33, 32)
    e.cus = r.sq(2.0 ** -29, 16)
    e.sqrt_a = r.uq(2.0 ** -19, 32)
    e.toe = r.uq(60.0, 14)
    e.cic = r.sq(2.0 ** -29, 16)
    e.omega0 = r.sq(2.0 ** -31, 32) * _SC
    e.cis = r.sq(2.0 ** -29, 16)
    e.i0 = r.sq(2.0 ** -31, 32) * _SC
    e.crc = r.sq(2.0 ** -5, 16)
    e.omega = r.sq(2.0 ** -31, 32) * _SC
    e.omega_dot = r.sq(2.0 ** -43, 24) * _SC
    e.tgd = r.sq(2.0 ** -32, 10)               # BGD E1/E5a
    bgd_e5b = r.sq(2.0 ** -32, 10)
    e5b_hs, _e5b_dvs = r.u(2), r.u(1)
    e1b_hs, _e1b_dvs = r.u(2), r.u(1)
    e.health = e1b_hs
    e.gm = constants.GM_EARTH_GAL
    return e, dict(bgd_e5b=bgd_e5b, e5b_health=e5b_hs, e1b_health=e1b_hs)


def encode_1006(station_id: int, ecef: np.ndarray, height_m: float, *,
                gps: bool = True, glo: bool = False, gal: bool = True
                ) -> np.ndarray:
    """Station reference point WITH antenna height (reference
    Rtcm::print_MT1006 / rtklib_rtcm3.cc decode_type1006)."""
    w = BitWriter()
    w.u(1006, 12)
    w.u(station_id, 12)
    w.u(0, 6)                      # ITRF realization year
    w.u(1 if gps else 0, 1)
    w.u(1 if glo else 0, 1)
    w.u(1 if gal else 0, 1)
    w.u(0, 1)
    w.sq(ecef[0], 1e-4, 38)
    w.u(0, 1)
    w.u(0, 1)
    w.sq(ecef[1], 1e-4, 38)
    w.u(0, 2)
    w.sq(ecef[2], 1e-4, 38)
    w.uq(height_m, 1e-4, 16)       # DF028 antenna height
    return w.array()


def decode_1006(bits: np.ndarray) -> dict:
    r = BitReader(bits)
    assert r.u(12) == 1006
    station = r.u(12)
    r.u(6)
    gps, glo, gal = r.u(1), r.u(1), r.u(1)
    r.u(1)
    x = r.sq(1e-4, 38)
    r.u(2)
    y = r.sq(1e-4, 38)
    r.u(2)
    z = r.sq(1e-4, 38)
    h = r.uq(1e-4, 16)
    return dict(station_id=station, ecef=np.array([x, y, z]),
                height_m=h, gps=bool(gps), glo=bool(glo), gal=bool(gal))


def encode_1020(eph) -> np.ndarray:
    """GLONASS broadcast ephemeris (GlonassEphemeris state vector).

    Field layout per RTCM 10403 MT1020 (reference ``Rtcm::print_MT1020``,
    ``rtklib_rtcm3.cc decode_type1020``): positions/velocities/accelerations
    in km sign-magnitude, tb as a 15-min index of the GLONASS day.
    """
    w = BitWriter()
    w.u(1020, 12)
    w.u(eph.slot, 6)
    w.u((eph.freq_slot + 7) & 0x1F, 5)
    w.u(0, 1)                      # almanac health
    w.u(0, 1)                      # almanac health availability
    w.u(0, 2)                      # P1
    tk = int(eph.tb_s)
    w.u((tk // 3600) % 32, 5)
    w.u((tk % 3600) // 60, 6)
    w.u((tk % 60) // 30, 1)
    w.u(1 if eph.health else 0, 1)  # Bn msb (unhealthy flag)
    w.u(0, 1)                      # P2
    w.u(int(round(eph.tb_s / 900.0)) & 0x7F, 7)
    w.smq(eph.vel_m_s[0] * 1e-3, 2.0 ** -20, 24)
    w.smq(eph.pos_m[0] * 1e-3, 2.0 ** -11, 27)
    w.smq(eph.acc_m_s2[0] * 1e-3, 2.0 ** -30, 5)
    w.smq(eph.vel_m_s[1] * 1e-3, 2.0 ** -20, 24)
    w.smq(eph.pos_m[1] * 1e-3, 2.0 ** -11, 27)
    w.smq(eph.acc_m_s2[1] * 1e-3, 2.0 ** -30, 5)
    w.smq(eph.vel_m_s[2] * 1e-3, 2.0 ** -20, 24)
    w.smq(eph.pos_m[2] * 1e-3, 2.0 ** -11, 27)
    w.smq(eph.acc_m_s2[2] * 1e-3, 2.0 ** -30, 5)
    w.u(0, 1)                      # P3
    w.smq(eph.gamma_n, 2.0 ** -40, 11)
    w.u(0, 2)                      # P
    w.u(0, 1)                      # ln (third string)
    w.smq(eph.tau_n, 2.0 ** -30, 22)
    w.smq(getattr(eph, "delta_tau_n", 0.0), 2.0 ** -30, 5)
    w.u(0, 5)                      # En (age)
    w.u(0, 1)                      # P4
    w.u(0, 4)                      # Ft
    w.u(0, 11)                     # Nt (day number)
    w.u(0, 2)                      # M (sat type)
    w.u(0, 1)                      # availability of additional data
    w.u(0, 11)                     # Na
    w.u(0, 32)                     # tau_c
    w.u(0, 5)                      # N4
    w.u(0, 22)                     # tau_gps
    w.u(0, 1)                      # ln (fifth string)
    w.u(0, 7)                      # reserved
    return w.array()


def decode_1020(bits: np.ndarray):
    from gnss_sdr_tpu_torch.models.nav.glonass_gnav import GlonassEphemeris
    r = BitReader(bits)
    assert r.u(12) == 1020
    slot = r.u(6)
    freq_slot = r.u(5) - 7
    r.u(1 + 1 + 2)                 # almanac health/avail, P1
    r.u(5 + 6 + 1)                 # tk
    bn = r.u(1)
    r.u(1)                         # P2
    tb = r.u(7) * 900.0
    vx = r.smq(2.0 ** -20, 24) * 1e3
    x = r.smq(2.0 ** -11, 27) * 1e3
    ax = r.smq(2.0 ** -30, 5) * 1e3
    vy = r.smq(2.0 ** -20, 24) * 1e3
    y = r.smq(2.0 ** -11, 27) * 1e3
    ay = r.smq(2.0 ** -30, 5) * 1e3
    vz = r.smq(2.0 ** -20, 24) * 1e3
    z = r.smq(2.0 ** -11, 27) * 1e3
    az = r.smq(2.0 ** -30, 5) * 1e3
    r.u(1)                         # P3
    gamma = r.smq(2.0 ** -40, 11)
    r.u(2 + 1)                     # P, ln
    tau = r.smq(2.0 ** -30, 22)
    r.smq(2.0 ** -30, 5)           # delta_tau
    return GlonassEphemeris(
        slot=slot, freq_slot=freq_slot, tb_s=tb,
        pos_m=(x, y, z), vel_m_s=(vx, vy, vz), acc_m_s2=(ax, ay, az),
        gamma_n=gamma, tau_n=tau, health=bn)


def encode_1042(eph: KeplerEphemeris) -> np.ndarray:
    """BeiDou D1/D2 broadcast ephemeris (RTCM 10403 MT1042; reference
    rtklib_rtcm3.cc decode_type1042 field table)."""
    w = BitWriter()
    w.u(1042, 12)
    w.u(eph.prn, 6)
    w.u(eph.week % 8192, 13)
    w.u(eph.ura & 0xF, 4)
    w.sq(eph.idot / _SC, 2.0 ** -43, 14)
    w.u(eph.iode & 0x1F, 5)                    # AODE
    w.uq(eph.toc, 8.0, 17)
    w.sq(eph.af2, 2.0 ** -66, 11)
    w.sq(eph.af1, 2.0 ** -50, 22)
    w.sq(eph.af0, 2.0 ** -33, 24)
    w.u(eph.iodc & 0x1F, 5)                    # AODC
    w.sq(eph.crs, 2.0 ** -6, 18)
    w.sq(eph.delta_n / _SC, 2.0 ** -43, 16)
    w.sq(eph.m0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cuc, 2.0 ** -31, 18)
    w.uq(eph.e, 2.0 ** -33, 32)
    w.sq(eph.cus, 2.0 ** -31, 18)
    w.uq(eph.sqrt_a, 2.0 ** -19, 32)
    w.uq(eph.toe, 8.0, 17)
    w.sq(eph.cic, 2.0 ** -31, 18)
    w.sq(eph.omega0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.cis, 2.0 ** -31, 18)
    w.sq(eph.i0 / _SC, 2.0 ** -31, 32)
    w.sq(eph.crc, 2.0 ** -6, 18)
    w.sq(eph.omega / _SC, 2.0 ** -31, 32)
    w.sq(eph.omega_dot / _SC, 2.0 ** -43, 24)
    w.sq(eph.tgd, 1e-10, 10)                   # TGD1 (0.1 ns)
    w.sq(0.0, 1e-10, 10)                       # TGD2
    w.u(eph.health & 1, 1)
    return w.array()


def decode_1042(bits: np.ndarray) -> KeplerEphemeris:
    from gnss_sdr_tpu_torch import constants
    r = BitReader(bits)
    assert r.u(12) == 1042
    e = KeplerEphemeris()
    e.prn = r.u(6)
    e.week = r.u(13)
    e.ura = r.u(4)
    e.idot = r.sq(2.0 ** -43, 14) * _SC
    e.iode = r.u(5)
    e.toc = r.uq(8.0, 17)
    e.af2 = r.sq(2.0 ** -66, 11)
    e.af1 = r.sq(2.0 ** -50, 22)
    e.af0 = r.sq(2.0 ** -33, 24)
    e.iodc = r.u(5)
    e.crs = r.sq(2.0 ** -6, 18)
    e.delta_n = r.sq(2.0 ** -43, 16) * _SC
    e.m0 = r.sq(2.0 ** -31, 32) * _SC
    e.cuc = r.sq(2.0 ** -31, 18)
    e.e = r.uq(2.0 ** -33, 32)
    e.cus = r.sq(2.0 ** -31, 18)
    e.sqrt_a = r.uq(2.0 ** -19, 32)
    e.toe = r.uq(8.0, 17)
    e.cic = r.sq(2.0 ** -31, 18)
    e.omega0 = r.sq(2.0 ** -31, 32) * _SC
    e.cis = r.sq(2.0 ** -31, 18)
    e.i0 = r.sq(2.0 ** -31, 32) * _SC
    e.crc = r.sq(2.0 ** -6, 18)
    e.omega = r.sq(2.0 ** -31, 32) * _SC
    e.omega_dot = r.sq(2.0 ** -43, 24) * _SC
    e.tgd = r.sq(1e-10, 10)
    r.sq(1e-10, 10)
    e.health = r.u(1)
    e.gm = constants.GM_EARTH_BDS
    return e


# ---------------------------------------------------------------------------
# MSM observables (reference Rtcm::print_MSM_1..7, rtcm.h)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MsmObservation:
    prn: int
    signal_id: int              # MSM signal slot (e.g. 2 = L1 C/A, per table)
    pseudorange_m: float
    phase_range_m: float = 0.0
    phase_rate_m_s: float = 0.0
    cn0_dbhz: float = 45.0
    lock_time_s: float = 0.0
    # False when the source message carries no phase rate (MSM1-4, legacy
    # 1002/1004/1012): consumers must not treat phase_rate_m_s=0 as a
    # measured Doppler (rtk_filter falls back to non-Doppler slip checks)
    has_rate: bool = True
    # GLONASS FDMA channel k (from the MSM extended satellite info field);
    # decides the per-slot carrier wavelength in differential processing
    freq_slot: int = 0
    # False when the source carries no carrier phase (MSM1)
    has_phase: bool = True
    # True for MSM1-3: the satellite data carries only the rough range
    # MODULO 1 ms (no DF397 integer-millisecond field), so pseudorange_m
    # is ambiguous by k * RANGE_MS and the consumer must resolve k from an
    # approximate position (rtklib decode_msm's partial-range handling)
    modulo_1ms: bool = False
    # False when the source carries no fine code observable (MSM2 is
    # phase-only): pseudorange_m is then only the 10-bit rough range
    # (~293 m quantization) and must not be used as a measured code range
    has_code: bool = True


MSM4_GPS, MSM5_GPS, MSM7_GPS = 1074, 1075, 1077
MSM4_GLO, MSM5_GLO, MSM7_GLO = 1084, 1085, 1087
MSM4_GAL, MSM5_GAL, MSM7_GAL = 1094, 1095, 1097
MSM1_GPS, MSM2_GPS, MSM3_GPS, MSM6_GPS = 1071, 1072, 1073, 1076
MSM1_GLO, MSM2_GLO, MSM3_GLO, MSM6_GLO = 1081, 1082, 1083, 1086
MSM1_GAL, MSM2_GAL, MSM3_GAL, MSM6_GAL = 1091, 1092, 1093, 1096
MSM4_BDS, MSM5_BDS, MSM7_BDS = 1124, 1125, 1127

# GPS-UTC leap seconds used for GLONASS<->GPS time-scale conversion in the
# codec (DF416/DF034 epochs are GLONASS time = UTC(SU) + 3 h). Current value;
# override for historical data.
GPS_UTC_LEAP_S = 18
_WEEK_MS = 7 * 24 * 3600 * 1000
_DAY_MS = 24 * 3600 * 1000


def gps_tow_ms_to_glonass_epoch(tow_ms: int,
                                leap_s: int = None) -> int:
    """30-bit GLONASS MSM epoch (DF416 day-of-week << 27 | DF034 time-of-day
    ms) from GPS time-of-week ms. GLONASS time = GPS - leap + 3 h."""
    leap = GPS_UTC_LEAP_S if leap_s is None else leap_s
    t = (int(tow_ms) - leap * 1000 + 10800 * 1000) % _WEEK_MS
    return ((t // _DAY_MS) << 27) | (t % _DAY_MS)


def glonass_epoch_to_gps_tow_ms(epoch30: int, leap_s: int = None) -> int:
    """Inverse of :func:`gps_tow_ms_to_glonass_epoch`."""
    leap = GPS_UTC_LEAP_S if leap_s is None else leap_s
    dow = epoch30 >> 27
    tod = epoch30 & ((1 << 27) - 1)
    return (dow * _DAY_MS + tod - 10800 * 1000 + leap * 1000) % _WEEK_MS


def glonass_tod_ms_to_gps_sod_ms(tod_ms: int, leap_s: int = None) -> int:
    """GPS second-of-day (ms) from a GLONASS 27-bit time-of-day (1012 epoch,
    UTC+3h). The day is NOT recoverable from the message; callers resolve it
    against a nearby known epoch (rtklib adjday_glot role)."""
    leap = GPS_UTC_LEAP_S if leap_s is None else leap_s
    return (int(tod_ms) - 10800 * 1000 + leap * 1000) % _DAY_MS


# msm level by message number: {msg: (level, system)}
MSM_MESSAGES = {
    1071 + k: (k + 1, "G") for k in range(7)
}
MSM_MESSAGES.update({1081 + k: (k + 1, "R") for k in range(7)})
MSM_MESSAGES.update({1091 + k: (k + 1, "E") for k in range(7)})
MSM_MESSAGES.update({1121 + k: (k + 1, "C") for k in range(7)})

# BDT = GPST - 14 s (constant; BDT has no leap seconds since 2006)
BDT_GPS_OFFSET_MS = 14_000

# per-level field layout (RTCM 10403 MSM1..7 content tables):
# (has_int_ms: DF397 integer-ms rough range present (MSM4-7; MSM1-3 carry
#  only the 10-bit modulo-1 ms DF398),
#  fine_pr (bits, scale) or None   — DF400 std / DF405 extended / absent,
#  fine_ph (bits, scale) or None   — DF401 std / DF406 extended / absent,
#  lock_bits                       — DF402 (4) / DF407 (10) / 0,
#  cnr (bits, scale) or None       — DF403 (6,1.0) / DF408 (10,2^-4),
#  has_rate                        — rough DF399 + fine DF404 (MSM5/7))
_MSM_LAYOUT = {
    1: (False, (15, 2.0 ** -24), None, 0, None, False),
    2: (False, None, (22, 2.0 ** -29), 4, None, False),
    3: (False, (15, 2.0 ** -24), (22, 2.0 ** -29), 4, None, False),
    4: (True, (15, 2.0 ** -24), (22, 2.0 ** -29), 4, (6, 1.0), False),
    5: (True, (15, 2.0 ** -24), (22, 2.0 ** -29), 4, (6, 1.0), True),
    6: (True, (20, 2.0 ** -29), (24, 2.0 ** -31), 10, (10, 2.0 ** -4), False),
    7: (True, (20, 2.0 ** -29), (24, 2.0 ** -31), 10, (10, 2.0 ** -4), True),
}


def encode_msm(msg_num: int, station_id: int, epoch_ms: int,
               obs: list[MsmObservation]) -> np.ndarray:
    """Encode one MSM1..7 message (reference Rtcm::print_MSM_1..7).

    The level and system come from ``msg_num`` (MSM_MESSAGES table).
    MSM1-3 carry the rough range modulo 1 ms only (no DF397), so the
    encoded pseudorange is ``pseudorange_m % RANGE_MS``.
    """
    level, system = MSM_MESSAGES[msg_num]
    has_int_ms, pr_l, ph_l, lock_bits, cnr_l, has_rate = _MSM_LAYOUT[level]
    sats = sorted({o.prn for o in obs})
    sigs = sorted({o.signal_id for o in obs})
    cell = {(o.prn, o.signal_id): o for o in obs}

    w = BitWriter()
    w.u(msg_num, 12)
    w.u(station_id, 12)
    if system == "R":
        # GLONASS MSM epoch is DF416 dow + DF034 tod (GLONASS time), not
        # GPS TOW (reference rtklib_rtcm3.cc encode/decode_msm_head)
        w.u(gps_tow_ms_to_glonass_epoch(epoch_ms), 30)
    elif system == "C":
        # BDS MSM epoch is BDT TOW; BDT = GPST - 14 s (rtklib
        # decode_msm_head: "tow += 14.0; /* BDT -> GPST */")
        w.u((epoch_ms - BDT_GPS_OFFSET_MS) % _WEEK_MS, 30)
    else:
        w.u(epoch_ms % _WEEK_MS, 30)
    w.u(0, 1)                  # multiple message bit
    w.u(0, 3)                  # IODS
    w.u(0, 7)                  # reserved
    w.u(0, 2)                  # clock steering
    w.u(0, 2)                  # external clock
    w.u(0, 1)                  # smoothing
    w.u(0, 3)                  # smoothing interval
    for s in range(1, 65):
        w.u(1 if s in sats else 0, 1)
    for s in range(1, 33):
        w.u(1 if s in sigs else 0, 1)
    cells = [(p, s) for p in sats for s in sigs]
    for c in cells:
        w.u(1 if c in cell else 0, 1)

    # satellite data: [int ms for MSM4-7 +] rough range frac (1/1024 ms)
    # [+ ext info + rough phase rate for MSM5/7]
    rough = {}
    for p in sats:
        any_o = next(o for o in obs if o.prn == p)
        n_ms = int(any_o.pseudorange_m / RANGE_MS) if has_int_ms else 0
        rough[p] = n_ms
        if has_int_ms:
            w.u(n_ms, 8)
    if has_rate:
        for p in sats:
            if system == "R":
                # extended satellite info = GLONASS frequency channel k+7
                # (rtklib decode_msm_head sateph/glo_fcn handling)
                any_o = next(o for o in obs if o.prn == p)
                w.u((any_o.freq_slot + 7) & 0xF, 4)
            else:
                w.u(0, 4)
    for p in sats:
        any_o = next(o for o in obs if o.prn == p)
        frac = any_o.pseudorange_m / RANGE_MS - (
            rough[p] if has_int_ms
            else int(any_o.pseudorange_m / RANGE_MS))
        w.u(int(frac * 1024.0), 10)
    if has_rate:
        for p in sats:
            any_o = next(o for o in obs if o.prn == p)
            w.s(int(round(any_o.phase_rate_m_s)), 14)

    def rough_range(o):
        # full-range anchor for the fine residuals; for MSM1-3 the decoder
        # only recovers (anchor mod 1 ms), the integer ms being the
        # receiver's to resolve (rtklib partial-range handling)
        base = (rough[o.prn] if has_int_ms
                else int(o.pseudorange_m / RANGE_MS))
        frac = int((o.pseudorange_m / RANGE_MS - base) * 1024.0) / 1024.0
        return (base + frac) * RANGE_MS

    present = [c for c in cells if c in cell]
    if pr_l is not None:
        pr_bits, pr_scale = pr_l
        for c in present:                   # fine pseudorange
            o = cell[c]
            w.sq((o.pseudorange_m - rough_range(o)) / RANGE_MS,
                 pr_scale, pr_bits)
    if ph_l is not None:
        ph_bits, ph_scale = ph_l
        for c in present:                   # fine phase range
            o = cell[c]
            w.sq((o.phase_range_m - rough_range(o)) / RANGE_MS,
                 ph_scale, ph_bits)
        for c in present:                   # lock time indicator
            w.u(min(int(cell[c].lock_time_s), (1 << lock_bits) - 1),
                lock_bits)
        for c in present:                   # half-cycle ambiguity
            w.u(0, 1)
    if cnr_l is not None:
        cnr_bits, cnr_scale = cnr_l
        for c in present:                   # CNR
            w.uq(min(cell[c].cn0_dbhz,
                     (1 << cnr_bits) * cnr_scale - cnr_scale),
                 cnr_scale, cnr_bits)
    if has_rate:
        for c in present:                   # fine phase rate, 0.0001 m/s
            o = cell[c]
            w.sq(o.phase_rate_m_s - round(o.phase_rate_m_s), 1e-4, 15)
    return w.array()


def decode_msm(bits: np.ndarray) -> tuple[dict, list[MsmObservation]]:
    """Decode any MSM1..7 message from MSM_MESSAGES.

    MSM1-3 observations come back with ``modulo_1ms=True``: their ranges
    are ambiguous by k * RANGE_MS (no DF397 in the message).
    """
    r = BitReader(bits)
    msg = r.u(12)
    level, system = MSM_MESSAGES[msg]
    has_int_ms, pr_l, ph_l, lock_bits, cnr_l, has_rate = _MSM_LAYOUT[level]
    station = r.u(12)
    raw_epoch = r.u(30)
    # report epoch_ms in GPS TOW for every system so downstream epoch
    # matching is time-scale-consistent; the raw GLONASS field is preserved
    if system == "R":
        epoch_ms = glonass_epoch_to_gps_tow_ms(raw_epoch)
    elif system == "C":
        epoch_ms = (raw_epoch + BDT_GPS_OFFSET_MS) % _WEEK_MS
    else:
        epoch_ms = raw_epoch
    r.u(1 + 3 + 7 + 2 + 2 + 1 + 3)
    sats = [s for s in range(1, 65) if r.u(1)]
    sigs = [s for s in range(1, 33) if r.u(1)]
    cells = [(p, s) for p in sats for s in sigs]
    present = [c for c in cells if r.u(1)]

    n_ms = ({p: r.u(8) for p in sats} if has_int_ms
            else {p: 0 for p in sats})
    ext = ({p: r.u(4) for p in sats} if has_rate
           else {p: 7 for p in sats})
    frac = {p: r.u(10) / 1024.0 for p in sats}
    rate = ({p: r.s(14) for p in sats} if has_rate
            else {p: 0 for p in sats})
    rough = {p: (n_ms[p] + frac[p]) * RANGE_MS for p in sats}

    n = len(present)
    if pr_l is not None:
        fine_pr = [r.sq(pr_l[1], pr_l[0]) * RANGE_MS for _ in present]
    else:
        fine_pr = [0.0] * n
    if ph_l is not None:
        fine_ph = [r.sq(ph_l[1], ph_l[0]) * RANGE_MS for _ in present]
        lock = [r.u(lock_bits) for _ in present]
        _half = [r.u(1) for _ in present]
    else:
        fine_ph = [0.0] * n
        lock = [0] * n
    if cnr_l is not None:
        cnr = [r.uq(cnr_l[1], cnr_l[0]) for _ in present]
    else:
        cnr = [0.0] * n
    fine_rate = ([r.sq(1e-4, 15) for _ in present] if has_rate
                 else [0.0] * n)

    out = []
    for k, (p, s) in enumerate(present):
        out.append(MsmObservation(
            prn=p, signal_id=s,
            pseudorange_m=rough[p] + fine_pr[k],
            phase_range_m=(rough[p] + fine_ph[k]
                           if ph_l is not None else 0.0),
            phase_rate_m_s=rate[p] + fine_rate[k],
            cn0_dbhz=cnr[k], lock_time_s=float(lock[k]),
            has_rate=bool(has_rate),
            freq_slot=(ext[p] - 7 if system == "R" else 0),
            has_phase=ph_l is not None,
            modulo_1ms=not has_int_ms,
            has_code=pr_l is not None))
    return dict(msg=msg, station_id=station, epoch_ms=epoch_ms,
                raw_epoch=raw_epoch), out


def resolve_modulo_range(pr_mod_m: float, approx_range_m: float) -> float:
    """Resolve the k * 1 ms ambiguity of an MSM1-3 range against an
    approximate geometric range (rtklib's partial-range resolution role)."""
    k = round((approx_range_m - pr_mod_m) / RANGE_MS)
    return pr_mod_m + k * RANGE_MS


def encode_msm7(msg_num: int, station_id: int, epoch_ms: int,
                obs: list[MsmObservation]) -> np.ndarray:
    """Back-compat wrapper (MSM7 only)."""
    return encode_msm(msg_num, station_id, epoch_ms, obs)


def decode_msm7(bits: np.ndarray) -> tuple[dict, list[MsmObservation]]:
    return decode_msm(bits)


# ---------------------------------------------------------------------------
# Legacy observables: 1002 (GPS L1 ext), 1004 (GPS L1+L2 ext),
# 1012 (GLONASS L1+L2 ext) — reference Rtcm::print_M1002/M1004/M1012
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LegacyObservation:
    prn: int
    pseudorange_m: float         # L1
    phase_range_m: float = 0.0   # L1 carrier phase-range (meters)
    lock_time_s: float = 0.0
    cn0_dbhz: float = 45.0
    # L2 block (1004/1012 only; None = not present)
    pseudorange_l2_m: float | None = None
    phase_range_l2_m: float | None = None
    cn0_l2_dbhz: float = 45.0
    freq_slot: int = 0           # GLONASS FDMA k in [-7, 6] (1012 only)


# DF013/DF019 lock-time indicator: piecewise nonlinear seconds->indicator
# mapping (RTCM 10403 Table 3.4-2; reference rtcm.cc lock_time_indicator).
# Each row: (indicator range start, seconds at that start, seconds per step).
_DF013_SEGMENTS = (
    (0, 0, 1), (24, 24, 2), (48, 72, 4), (72, 168, 8),
    (96, 360, 16), (120, 744, 32),
)


def _lock_indicator(lock_s: float) -> int:
    if lock_s >= 937:
        return 127
    for i0, s0, step in reversed(_DF013_SEGMENTS):
        if lock_s >= s0:
            return i0 + int((lock_s - s0) // step)
    return 0


def _lock_seconds(indicator: int) -> float:
    """Inverse of DF013: minimum lock seconds for an indicator value."""
    if indicator >= 127:
        return 937.0
    for i0, s0, step in reversed(_DF013_SEGMENTS):
        if indicator >= i0:
            return float(s0 + (indicator - i0) * step)
    return 0.0


def _legacy_l1_block(w: BitWriter, o: LegacyObservation, glonass: bool):
    """Shared L1 body of 1002/1004/1012."""
    pr_bits = 25 if glonass else 24
    w.u(0, 1)                                   # L1 code indicator (C/A)
    if glonass:
        w.u(o.freq_slot + 7, 5)
    amb = int(o.pseudorange_m / RANGE_MS)
    pr_mod = o.pseudorange_m - amb * RANGE_MS
    w.uq(pr_mod, 0.02, pr_bits)
    # phaserange - pseudorange, 0.0005 m signed 20 bits
    w.sq(o.phase_range_m - o.pseudorange_m, 5e-4, 20)
    w.u(_lock_indicator(o.lock_time_s), 7)
    w.u(amb, 8 if not glonass else 7)
    w.uq(min(o.cn0_dbhz, 63.75), 0.25, 8)
    return amb


def _legacy_l2_block(w: BitWriter, o: LegacyObservation):
    w.u(0, 2)                                   # L2 code indicator
    if o.pseudorange_l2_m is None:
        w.s(-8192, 14)                          # no L2 (invalid marker)
        w.s(-524288, 20)
        w.u(0, 7)
        w.u(0, 8)
        return
    w.sq(o.pseudorange_l2_m - o.pseudorange_m, 0.02, 14)
    w.sq(o.phase_range_l2_m - o.pseudorange_m, 5e-4, 20)
    w.u(_lock_indicator(o.lock_time_s), 7)
    w.uq(min(o.cn0_l2_dbhz, 63.75), 0.25, 8)


def encode_1002(station_id: int, tow_ms: int,
                obs: list[LegacyObservation]) -> np.ndarray:
    w = BitWriter()
    w.u(1002, 12)
    w.u(station_id, 12)
    w.u(tow_ms, 30)
    w.u(0, 1)                   # sync
    w.u(len(obs), 5)
    w.u(0, 1)                   # smoothing
    w.u(0, 3)                   # smoothing interval
    for o in obs:
        w.u(o.prn, 6)
        _legacy_l1_block(w, o, glonass=False)
    return w.array()


def encode_1004(station_id: int, tow_ms: int,
                obs: list[LegacyObservation]) -> np.ndarray:
    w = BitWriter()
    w.u(1004, 12)
    w.u(station_id, 12)
    w.u(tow_ms, 30)
    w.u(0, 1)
    w.u(len(obs), 5)
    w.u(0, 1)
    w.u(0, 3)
    for o in obs:
        w.u(o.prn, 6)
        _legacy_l1_block(w, o, glonass=False)
        _legacy_l2_block(w, o)
    return w.array()


def encode_1012(station_id: int, tod_ms: int,
                obs: list[LegacyObservation]) -> np.ndarray:
    """GLONASS extended L1+L2; epoch is time-of-day (UTC+3) ms, 27 bits."""
    w = BitWriter()
    w.u(1012, 12)
    w.u(station_id, 12)
    w.u(tod_ms, 27)
    w.u(0, 1)
    w.u(len(obs), 5)
    w.u(0, 1)
    w.u(0, 3)
    for o in obs:
        w.u(o.prn, 6)
        _legacy_l1_block(w, o, glonass=True)
        _legacy_l2_block(w, o)
    return w.array()


def _decode_legacy_l1(r: BitReader, glonass: bool):
    r.u(1)
    freq_slot = (r.u(5) - 7) if glonass else 0
    pr_mod = r.uq(0.02, 25 if glonass else 24)
    dph = r.sq(5e-4, 20)
    lock = r.u(7)
    amb = r.u(7 if glonass else 8)
    cnr = r.uq(0.25, 8)
    pr = amb * RANGE_MS + pr_mod
    return dict(pseudorange_m=pr, phase_range_m=pr + dph,
                lock_time_s=_lock_seconds(lock), cn0_dbhz=cnr,
                freq_slot=freq_slot)


def _decode_legacy_l2(r: BitReader, l1: dict):
    r.u(2)
    dpr = r.s(14)
    dph = r.s(20)
    r.u(7)
    cnr = r.uq(0.25, 8)
    if dpr == -8192:
        return dict(pseudorange_l2_m=None, phase_range_l2_m=None)
    return dict(pseudorange_l2_m=l1["pseudorange_m"] + dpr * 0.02,
                phase_range_l2_m=l1["pseudorange_m"] + dph * 5e-4,
                cn0_l2_dbhz=cnr)


def decode_legacy_obs(bits: np.ndarray) -> tuple[dict, list[LegacyObservation]]:
    """Decode 1002 / 1004 / 1012."""
    r = BitReader(bits)
    msg = r.u(12)
    station = r.u(12)
    epoch_ms = r.u(27 if msg in (1009, 1010, 1011, 1012) else 30)
    r.u(1)
    n = r.u(5)
    r.u(1 + 3)
    glonass = msg in (1009, 1010, 1011, 1012)
    out = []
    for _ in range(n):
        prn = r.u(6)
        l1 = _decode_legacy_l1(r, glonass)
        l2 = (_decode_legacy_l2(r, l1) if msg in (1004, 1012)
              else {})
        out.append(LegacyObservation(prn=prn, **l1, **l2))
    return dict(msg=msg, station_id=station, epoch_ms=epoch_ms), out


# ---------------------------------------------------------------------------
# SSR corrections: 1057-1059 (GPS), 1063-1065 (GLONASS), 1240-1242
# (Galileo) — orbit / clock / code-bias triplets sharing one field layout
# that differs only in epoch width (GLONASS time-of-day is 17 bits vs the
# 20-bit GPS TOW), satellite-id width and IODE width (reference
# rtklib_rtcm3.cc decode_ssr1_head np/ni tables + decode_ssr1/2/3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SsrOrbitCorrection:
    prn: int
    iode: int
    radial_m: float              # delta-orbit in the radial direction
    along_m: float
    cross_m: float
    dot_radial_m_s: float = 0.0
    dot_along_m_s: float = 0.0
    dot_cross_m_s: float = 0.0
    system: str = "G"


@dataclasses.dataclass
class SsrClockCorrection:
    prn: int
    c0_m: float                  # delta-clock polynomial (meters)
    c1_m_s: float = 0.0
    c2_m_s2: float = 0.0
    system: str = "G"


# (orbit, clock, code-bias) message numbers; epoch/prn/iode bit widths
_SSR_MSGS = {"G": (1057, 1058, 1059), "R": (1063, 1064, 1065),
             "E": (1240, 1241, 1242)}
# combined orbit+clock messages (GPS 1060 / GLONASS 1066 / Galileo 1243)
_SSR_COMBINED = {"G": 1060, "R": 1066, "E": 1243}
_SSR_SYS = {m: (s, kind) for s, nums in _SSR_MSGS.items()
            for kind, m in zip(("orbit", "clock", "bias"), nums)}
_SSR_SYS.update({m: (s, "combined") for s, m in _SSR_COMBINED.items()})
_SSR_WIDTHS = {"G": (20, 6, 8), "R": (17, 5, 8), "E": (20, 6, 10)}


def _ssr_head(w: BitWriter, msg: int, tow_s: int, iod: int, nsat: int,
              refd: bool | None, system: str = "G") -> None:
    ne, _np, _ni = _SSR_WIDTHS[system]
    w.u(msg, 12)
    # GLONASS: 17-bit time of day; others: 20-bit GPS TOW
    w.u(int(tow_s) % (86400 if ne == 17 else 604800), ne)
    w.u(2, 4)                   # update interval index (10 s)
    w.u(0, 1)                   # sync
    if refd is not None:
        w.u(1 if refd else 0, 1)    # satellite reference datum (orbit only)
    w.u(iod & 15, 4)
    w.u(0, 16)                  # provider id
    w.u(0, 4)                   # solution id
    w.u(nsat, 6)


def _ssr_head_dec(r: BitReader, refd: bool) -> tuple[dict, int, str]:
    msg = r.u(12)
    system, _kind = _SSR_SYS[msg]
    ne, _np, _ni = _SSR_WIDTHS[system]
    tow = r.u(ne)
    r.u(4 + 1 + (1 if refd else 0))     # udi, sync, (refd)
    iod = r.u(4)
    r.u(16 + 4)
    nsat = r.u(6)
    return dict(msg=msg, tow_s=float(tow), iod=iod, system=system), \
        nsat, system


def encode_ssr_orbit(tow_s: float, corrections: list[SsrOrbitCorrection],
                     iod: int = 0, system: str = "G") -> np.ndarray:
    """RTCM 1057 / 1063 / 1240: SSR orbit corrections (GPS/GLONASS/Gal).
    GLONASS passes ``tow_s`` as GLONASS time-of-day seconds."""
    _ne, np_, ni = _SSR_WIDTHS[system]
    w = BitWriter()
    _ssr_head(w, _SSR_MSGS[system][0], int(tow_s), iod, len(corrections),
              refd=False, system=system)
    for c in corrections:
        w.u(c.prn, np_)
        w.u(c.iode & ((1 << ni) - 1), ni)
        w.sq(c.radial_m, 1e-4, 22)
        w.sq(c.along_m, 4e-4, 20)
        w.sq(c.cross_m, 4e-4, 20)
        w.sq(c.dot_radial_m_s, 1e-6, 21)
        w.sq(c.dot_along_m_s, 4e-6, 19)
        w.sq(c.dot_cross_m_s, 4e-6, 19)
    return w.array()


def decode_ssr_orbit(bits: np.ndarray
                     ) -> tuple[dict, list[SsrOrbitCorrection]]:
    r = BitReader(bits)
    hdr, nsat, system = _ssr_head_dec(r, refd=True)
    _ne, np_, ni = _SSR_WIDTHS[system]
    out = []
    for _ in range(nsat):
        prn = r.u(np_)
        iode = r.u(ni)
        out.append(SsrOrbitCorrection(
            prn=prn, iode=iode,
            radial_m=r.sq(1e-4, 22), along_m=r.sq(4e-4, 20),
            cross_m=r.sq(4e-4, 20), dot_radial_m_s=r.sq(1e-6, 21),
            dot_along_m_s=r.sq(4e-6, 19), dot_cross_m_s=r.sq(4e-6, 19),
            system=system))
    return hdr, out


def encode_ssr_clock(tow_s: float, corrections: list[SsrClockCorrection],
                     iod: int = 0, system: str = "G") -> np.ndarray:
    """RTCM 1058 / 1064 / 1241: SSR clock corrections."""
    _ne, np_, _ni = _SSR_WIDTHS[system]
    w = BitWriter()
    _ssr_head(w, _SSR_MSGS[system][1], int(tow_s), iod, len(corrections),
              refd=None, system=system)
    for c in corrections:
        w.u(c.prn, np_)
        w.sq(c.c0_m, 1e-4, 22)
        w.sq(c.c1_m_s, 1e-6, 21)
        w.sq(c.c2_m_s2, 2e-8, 27)
    return w.array()


def decode_ssr_clock(bits: np.ndarray
                     ) -> tuple[dict, list[SsrClockCorrection]]:
    r = BitReader(bits)
    hdr, nsat, system = _ssr_head_dec(r, refd=False)
    _ne, np_, _ni = _SSR_WIDTHS[system]
    out = []
    for _ in range(nsat):
        prn = r.u(np_)
        out.append(SsrClockCorrection(
            prn=prn, c0_m=r.sq(1e-4, 22), c1_m_s=r.sq(1e-6, 21),
            c2_m_s2=r.sq(2e-8, 27), system=system))
    return hdr, out


def encode_ssr_combined(tow_s: float, orbits: list[SsrOrbitCorrection],
                        clocks: list[SsrClockCorrection], iod: int = 0,
                        system: str = "G") -> np.ndarray:
    """RTCM 1060 / 1066 / 1243: combined SSR orbit+clock corrections —
    one record per satellite carrying both the orbit RAC deltas (+IODE)
    and the clock polynomial (rtklib decode_ssr4)."""
    _ne, np_, ni = _SSR_WIDTHS[system]
    clk = {c.prn: c for c in clocks}
    w = BitWriter()
    _ssr_head(w, _SSR_COMBINED[system], int(tow_s), iod, len(orbits),
              refd=False, system=system)
    for c in orbits:
        k = clk.get(c.prn)
        if k is None:
            raise ValueError(f"no clock correction for PRN {c.prn}")
        w.u(c.prn, np_)
        w.u(c.iode & ((1 << ni) - 1), ni)
        w.sq(c.radial_m, 1e-4, 22)
        w.sq(c.along_m, 4e-4, 20)
        w.sq(c.cross_m, 4e-4, 20)
        w.sq(c.dot_radial_m_s, 1e-6, 21)
        w.sq(c.dot_along_m_s, 4e-6, 19)
        w.sq(c.dot_cross_m_s, 4e-6, 19)
        w.sq(k.c0_m, 1e-4, 22)
        w.sq(k.c1_m_s, 1e-6, 21)
        w.sq(k.c2_m_s2, 2e-8, 27)
    return w.array()


def decode_ssr_combined(bits: np.ndarray) -> tuple[
        dict, list[SsrOrbitCorrection], list[SsrClockCorrection]]:
    r = BitReader(bits)
    hdr, nsat, system = _ssr_head_dec(r, refd=True)
    _ne, np_, ni = _SSR_WIDTHS[system]
    orbits, clocks = [], []
    for _ in range(nsat):
        prn = r.u(np_)
        iode = r.u(ni)
        orbits.append(SsrOrbitCorrection(
            prn=prn, iode=iode,
            radial_m=r.sq(1e-4, 22), along_m=r.sq(4e-4, 20),
            cross_m=r.sq(4e-4, 20), dot_radial_m_s=r.sq(1e-6, 21),
            dot_along_m_s=r.sq(4e-6, 19), dot_cross_m_s=r.sq(4e-6, 19),
            system=system))
        clocks.append(SsrClockCorrection(
            prn=prn, c0_m=r.sq(1e-4, 22), c1_m_s=r.sq(1e-6, 21),
            c2_m_s2=r.sq(2e-8, 27), system=system))
    return hdr, orbits, clocks


# GPS-named aliases (original entry points)
def encode_ssr_orbit_gps(tow_s, corrections, iod=0):
    return encode_ssr_orbit(tow_s, corrections, iod, system="G")


def decode_ssr_orbit_gps(bits):
    return decode_ssr_orbit(bits)


def encode_ssr_clock_gps(tow_s, corrections, iod=0):
    return encode_ssr_clock(tow_s, corrections, iod, system="G")


def decode_ssr_clock_gps(bits):
    return decode_ssr_clock(bits)


def apply_ssr_orbit(pos_ecef: np.ndarray, vel_ecef: np.ndarray,
                    corr: SsrOrbitCorrection, dt_s: float = 0.0
                    ) -> np.ndarray:
    """Apply an SSR orbit correction to a broadcast satellite position.

    IGS SSR convention (reference rtklib_sbas/ssr application): the
    correction is expressed in the radial/along-track/cross-track frame
    built from the broadcast position and velocity, and the PRECISE
    position is broadcast MINUS the rotated correction.
    """
    r = np.asarray(pos_ecef, float)
    v = np.asarray(vel_ecef, float)
    ea = v / np.linalg.norm(v)
    ec = np.cross(r, v)
    ec = ec / np.linalg.norm(ec)
    er = np.cross(ea, ec)
    d = np.array([corr.radial_m + corr.dot_radial_m_s * dt_s,
                  corr.along_m + corr.dot_along_m_s * dt_s,
                  corr.cross_m + corr.dot_cross_m_s * dt_s])
    return r - (er * d[0] + ea * d[1] + ec * d[2])


def apply_ssr_clock(dts_s: float, corr: SsrClockCorrection,
                    dt_s: float = 0.0) -> float:
    """Broadcast SV clock (s) + SSR delta-clock polynomial (meters -> s)."""
    dc = corr.c0_m + corr.c1_m_s * dt_s + corr.c2_m_s2 * dt_s * dt_s
    return dts_s + dc / SPEED_OF_LIGHT


@dataclasses.dataclass
class SsrCodeBias:
    """One satellite's per-signal code biases (RTCM 1059/1065/1242;
    signal ids are the per-system RTCM signal-and-tracking-mode table
    indices)."""

    prn: int
    biases: dict = dataclasses.field(default_factory=dict)  # sig_id -> m
    system: str = "G"


def encode_ssr_code_bias(tow_s: float, biases: list[SsrCodeBias],
                         iod: int = 0, system: str = "G") -> np.ndarray:
    """RTCM 1059 / 1065 / 1242: SSR code biases (reference
    rtklib_rtcm3.cc decode_ssr3 field layout)."""
    _ne, np_, _ni = _SSR_WIDTHS[system]
    w = BitWriter()
    _ssr_head(w, _SSR_MSGS[system][2], int(tow_s), iod, len(biases),
              refd=None, system=system)
    for b in biases:
        w.u(b.prn, np_)
        w.u(len(b.biases), 5)
        for sig_id, bias_m in sorted(b.biases.items()):
            w.u(sig_id, 5)
            w.sq(bias_m, 0.01, 14)
    return w.array()


def decode_ssr_code_bias(bits: np.ndarray
                         ) -> tuple[dict, list[SsrCodeBias]]:
    r = BitReader(bits)
    hdr, nsat, system = _ssr_head_dec(r, refd=False)
    _ne, np_, _ni = _SSR_WIDTHS[system]
    out = []
    for _ in range(nsat):
        prn = r.u(np_)
        nb = r.u(5)
        biases = {}
        for _ in range(nb):
            sig = r.u(5)
            biases[sig] = r.sq(0.01, 14)
        out.append(SsrCodeBias(prn=prn, biases=biases, system=system))
    return hdr, out


def encode_ssr_code_bias_gps(tow_s, biases, iod=0):
    return encode_ssr_code_bias(tow_s, biases, iod, system="G")


def decode_ssr_code_bias_gps(bits):
    return decode_ssr_code_bias(bits)


def apply_ssr_code_bias(pseudorange_m: float, corr: SsrCodeBias,
                        sig_id: int) -> float:
    """Corrected pseudorange = PR + bias (IGS SSR convention, matching
    rtklib's `prange + cbias` application in ppp/pntpos)."""
    return pseudorange_m + corr.biases.get(sig_id, 0.0)


# ---------------------------------------------------------------------------
# TCP broadcast server (reference: Rtcm_Printer's TCP server / NTRIP-less)
# ---------------------------------------------------------------------------


class RtcmServer:
    """Accepts TCP clients and broadcasts framed RTCM messages to all."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                self._clients.append(conn)

    def send(self, payload_bits: np.ndarray) -> None:
        data = frame(payload_bits)
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    c.sendall(data)
                    alive.append(c)
                except OSError:
                    c.close()
            self._clients = alive

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                c.close()
            self._clients.clear()
        self._thread.join(timeout=2.0)
