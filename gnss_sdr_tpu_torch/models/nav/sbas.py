"""SBAS L1 message codec (DO-229 MOPS framing; the port's copy of
gnss_sdr_tpu/models/nav/sbas.py).

Reference analog: ``sbas_l1_telemetry_decoder_gs.cc`` — 250 bps messages,
rate-1/2 K=7 convolutionally encoded to 500 sps (the encoder runs
continuously across messages, no per-message flush), each 1-second block:

  [8-bit preamble (cycling 0x53, 0x9A, 0xC6) | 6-bit type | 212-bit data |
   24-bit CRC-24Q over the preceding 226 bits]

Decoded messages are returned as (type, data bits); fast corrections
(types 2-5) and PRN mask (type 1) get field-level parsers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.models.nav import fec

PREAMBLES = (0x53, 0x9A, 0xC6)
MSG_BITS = 250
MSG_SYMBOLS = 500


def _u2b(value: int, n: int) -> np.ndarray:
    return np.array([(int(value) >> (n - 1 - i)) & 1 for i in range(n)],
                    np.uint8)


def _b2u(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def encode_message(msg_type: int, data212: np.ndarray,
                   preamble_index: int) -> np.ndarray:
    """One 250-bit message (before FEC)."""
    data212 = np.asarray(data212, np.uint8)
    assert len(data212) == 212
    head = np.concatenate([
        _u2b(PREAMBLES[preamble_index % 3], 8),
        _u2b(msg_type, 6), data212])
    crc = fec.crc24q_bits(head)
    return np.concatenate([head, _u2b(crc, 24)])


def encode_stream(messages: list[tuple[int, np.ndarray]]) -> np.ndarray:
    """Messages -> continuous 500 sps symbol stream (no per-message flush,
    DO-229 continuous convolutional encoding)."""
    bits = np.concatenate([
        encode_message(t, d, k) for k, (t, d) in enumerate(messages)])
    return fec.conv_encode(bits, invert_g2=False, flush=False)


def decode_stream(symbols: np.ndarray, *, max_messages: int = 64
                  ) -> list[tuple[int, int, np.ndarray]]:
    """Soft 500 sps symbols (+amp == bit 1) -> [(bit_offset, type, data212)].

    Viterbi-decodes the whole window, then slides over the bit stream
    checking the preamble + CRC at every offset (handles unknown message
    phase and stream polarity; the CRC arbitrates). The window may start at
    EITHER parity of the rate-1/2 symbol pairing relative to the encoder's
    bit grid — a live tracking channel anchors symbols with a one-symbol
    ambiguity — so both parities are tried; reported bit offsets are
    relative to the (possibly parity-shifted) decode start.
    """
    sym_in = np.asarray(symbols, np.float64)
    for parity in (0, 1):
        out: list[tuple[int, int, np.ndarray]] = []
        sym = sym_in[parity:]
        n_bits = len(sym) // 2 - 8
        if n_bits < MSG_BITS:
            return out
        for pol in (1.0, -1.0):
            bits = fec.viterbi_decode(pol * sym, n_bits, invert_g2=False)
            for off in range(0, n_bits - MSG_BITS + 1):
                if len(out) >= max_messages:
                    return out
                pre = _b2u(bits[off: off + 8])
                if pre not in PREAMBLES:
                    continue
                head = bits[off: off + 226]
                crc_rx = _b2u(bits[off + 226: off + 250])
                if fec.crc24q_bits(head) != crc_rx:
                    continue
                mtype = _b2u(bits[off + 8: off + 14])
                out.append((off, mtype, bits[off + 14: off + 226].copy()))
            if out:
                return out
    return out


# ---------------------------------------------------------------------------
# Field parsers for the PVT-relevant types
# ---------------------------------------------------------------------------


def parse_type1_mask(data212: np.ndarray) -> list[int]:
    """Type 1 PRN mask -> ordered list of PRNs covered by corrections."""
    mask = data212[:210]
    prns = []
    for i, b in enumerate(mask[:51]):          # GPS PRN 1..51 region (bits 1..51)
        if b:
            prns.append(i + 1)
    for i, b in enumerate(mask[51:210]):
        if b:
            prns.append(i + 52)
    return prns


def parse_fast_corrections(msg_type: int, data212: np.ndarray
                           ) -> tuple[int, list[float], list[int]]:
    """Types 2-5: (IODF, 13 x PRC meters, 13 x UDREI)."""
    iodf = _b2u(data212[0:2])
    # data212[2:4] = IODP
    prcs = []
    for k in range(13):
        v = _b2u(data212[4 + 12 * k: 4 + 12 * (k + 1)])
        if v >= 2048:
            v -= 4096
        prcs.append(v * 0.125)                 # 0.125 m resolution
    udrei = [
        _b2u(data212[160 + 4 * k: 160 + 4 * (k + 1)]) for k in range(13)]
    return iodf, prcs, udrei


def parse_type18_igp_mask(data212: np.ndarray) -> dict:
    """Type 18 IGP mask (DO-229; reference rtklib_sbas.cc
    decode_sbstype18): which grid points of one band carry corrections.

    Message-relative offsets shifted by the 14-bit header: n_bands(4)@0,
    band(4)@4, IODI(2)@8, 201-bit mask@10.
    """
    return dict(
        n_bands=_b2u(data212[0:4]),
        band=_b2u(data212[4:8]),
        iodi=_b2u(data212[8:10]),
        igps=[i + 1 for i in range(201) if data212[10 + i]])


def encode_type18_igp_mask(band: int, igps: list[int], iodi: int = 0,
                           n_bands: int = 1) -> np.ndarray:
    d = np.zeros(212, np.uint8)
    d[0:4] = _u2b(n_bands, 4)
    d[4:8] = _u2b(band, 4)
    d[8:10] = _u2b(iodi, 2)
    for igp in igps:
        d[10 + igp - 1] = 1
    return d


def parse_type26_iono_delays(data212: np.ndarray) -> dict:
    """Type 26 iono vertical delays for one 15-IGP block of a band
    (reference decode_sbstype26): band(4)@0, block(4)@4, then 15 x
    {delay(9) x 0.125 m, GIVEI(4)}, IODI(2)@199. Delay 0x1FF = don't use."""
    out = []
    for k in range(15):
        p = 8 + 13 * k
        raw = _b2u(data212[p: p + 9])
        give = _b2u(data212[p + 9: p + 13])
        out.append((None if raw == 0x1FF else raw * 0.125, give))
    return dict(band=_b2u(data212[0:4]), block=_b2u(data212[4:8]),
                delays=out, iodi=_b2u(data212[199:201]))


def encode_type26_iono_delays(band: int, block: int,
                              delays: list, iodi: int = 0) -> np.ndarray:
    """``delays``: up to 15 (delay_m | None, givei) entries."""
    d = np.zeros(212, np.uint8)
    d[0:4] = _u2b(band, 4)
    d[4:8] = _u2b(block, 4)
    for k in range(15):
        p = 8 + 13 * k
        if k < len(delays) and delays[k][0] is not None:
            d[p: p + 9] = _u2b(int(round(delays[k][0] / 0.125)), 9)
            d[p + 9: p + 13] = _u2b(delays[k][1], 4)
        else:
            d[p: p + 9] = _u2b(0x1FF, 9)
    d[199:201] = _u2b(iodi, 2)
    return d


def _s2b(value: int, n: int) -> np.ndarray:
    return _u2b(int(value) & ((1 << n) - 1), n)


def _b2s(bits) -> int:
    v = _b2u(bits)
    if v >= 1 << (len(bits) - 1):
        v -= 1 << len(bits)
    return v


class LongTermCorrection:
    """One satellite's MT24/25 long-term correction (reference sbssatp_t
    lcorr): ECEF position offset (+velocity) and clock offset (+drift)."""

    def __init__(self, mask_no: int, iode: int, dpos, daf0: float,
                 dvel=(0.0, 0.0, 0.0), daf1: float = 0.0,
                 t0_s: float | None = None):
        self.mask_no = mask_no
        self.iode = iode
        self.dpos = tuple(dpos)
        self.dvel = tuple(dvel)
        self.daf0 = daf0
        self.daf1 = daf1
        self.t0_s = t0_s

    def at(self, t_s: float) -> tuple[np.ndarray, float]:
        """(dpos ECEF [m], ddts [s]) at time t (reference sbslongcorr)."""
        dt = 0.0 if self.t0_s is None else t_s - self.t0_s
        return (np.array(self.dpos) + np.array(self.dvel) * dt,
                self.daf0 + self.daf1 * dt)


def parse_long_term_half(data212: np.ndarray, p: int,
                         tow_s: float | None = None) -> list:
    """One 106-bit long-term half-message at data-relative offset ``p``
    (reference decode_longcorrh/longcorr0/longcorr1; message offsets are
    14 higher). Returns [] on empty slots."""
    out = []
    vel = int(data212[p])
    if vel == 0:
        for q in (p + 1, p + 52):
            n = _b2u(data212[q: q + 6])
            if n == 0:
                continue
            out.append(LongTermCorrection(
                mask_no=n, iode=_b2u(data212[q + 6: q + 14]),
                dpos=[_b2s(data212[q + 14 + 9 * i: q + 23 + 9 * i]) * 0.125
                      for i in range(3)],
                daf0=_b2s(data212[q + 41: q + 51]) * 2.0 ** -31,
                t0_s=tow_s))
    else:
        q = p + 1
        n = _b2u(data212[q: q + 6])
        if n:
            t0 = _b2u(data212[q + 90: q + 103]) * 16.0
            if tow_s is not None:
                # align t0 to the nearest day around tow (rtklib wrap)
                t = t0 - (tow_s % 86400.0)
                if t <= -43200:
                    t += 86400
                elif t > 43200:
                    t -= 86400
                t0 = tow_s + t
            out.append(LongTermCorrection(
                mask_no=n, iode=_b2u(data212[q + 6: q + 14]),
                dpos=[_b2s(data212[q + 14 + 11 * i: q + 25 + 11 * i]) * 0.125
                      for i in range(3)],
                daf0=_b2s(data212[q + 47: q + 58]) * 2.0 ** -31,
                dvel=[_b2s(data212[q + 58 + 8 * i: q + 66 + 8 * i])
                      * 2.0 ** -11 for i in range(3)],
                daf1=_b2s(data212[q + 82: q + 90]) * 2.0 ** -39,
                t0_s=t0))
    return out


def parse_type25(data212: np.ndarray,
                 tow_s: float | None = None) -> list:
    """Type 25: two long-term half-messages (reference decode_sbstype25)."""
    return (parse_long_term_half(data212, 0, tow_s)
            + parse_long_term_half(data212, 106, tow_s))


def parse_type24(data212: np.ndarray, tow_s: float | None = None) -> dict:
    """Type 24 mixed: 6 fast corrections for block ``blk`` + one long-term
    half-message (reference decode_sbstype24)."""
    prcs = [_b2s(data212[12 * i: 12 * i + 12]) * 0.125 for i in range(6)]
    udrei = [_b2u(data212[72 + 4 * i: 76 + 4 * i]) for i in range(6)]
    return dict(
        iodp=_b2u(data212[96:98]), block=_b2u(data212[98:100]),
        iodf=_b2u(data212[100:102]), prcs=prcs, udrei=udrei,
        long_term=parse_long_term_half(data212, 106, tow_s))


def encode_type25_half(corr: LongTermCorrection | None,
                       second: LongTermCorrection | None = None,
                       velocity: bool = False, iodp: int = 0) -> np.ndarray:
    """One 106-bit half (the test oracle for parse_long_term_half)."""
    h = np.zeros(106, np.uint8)
    if velocity:
        assert corr is not None and second is None
        h[0] = 1
        q = 1
        h[q: q + 6] = _u2b(corr.mask_no, 6)
        h[q + 6: q + 14] = _u2b(corr.iode, 8)
        for i in range(3):
            h[q + 14 + 11 * i: q + 25 + 11 * i] = _s2b(
                int(round(corr.dpos[i] / 0.125)), 11)
        h[q + 47: q + 58] = _s2b(int(round(corr.daf0 / 2.0 ** -31)), 11)
        for i in range(3):
            h[q + 58 + 8 * i: q + 66 + 8 * i] = _s2b(
                int(round(corr.dvel[i] / 2.0 ** -11)), 8)
        h[q + 82: q + 90] = _s2b(int(round(corr.daf1 / 2.0 ** -39)), 8)
        h[q + 90: q + 103] = _u2b(int(round((corr.t0_s or 0.0) % 86400
                                            / 16.0)), 13)
        h[104:106] = _u2b(iodp, 2)
    else:
        for q, c in ((1, corr), (52, second)):
            if c is None:
                continue
            h[q: q + 6] = _u2b(c.mask_no, 6)
            h[q + 6: q + 14] = _u2b(c.iode, 8)
            for i in range(3):
                h[q + 14 + 9 * i: q + 23 + 9 * i] = _s2b(
                    int(round(c.dpos[i] / 0.125)), 9)
            h[q + 41: q + 51] = _s2b(int(round(c.daf0 / 2.0 ** -31)), 10)
        h[103:105] = _u2b(iodp, 2)
    return h


def encode_type25(half1: np.ndarray, half2: np.ndarray) -> np.ndarray:
    return np.concatenate([half1, half2])


# ---------------------------------------------------------------------------
# IGP grid (DO-229 Table A-14, bands 0-8) + iono correction application
# (reference rtklib_sbas.h IGPBAND1 / rtklib_sbas.cc searchigp, sbsioncorr)
# ---------------------------------------------------------------------------

# latitude column patterns (specification data, DO-229 Table A-14)
_LAT_A = (-75, -65) + tuple(range(-55, 60, 5)) + (65, 75, 85)   # 28 pts
_LAT_B = tuple(range(-55, 60, 5))                               # 23 pts
_LAT_C = (-75, -65) + tuple(range(-55, 60, 5)) + (65, 75)       # 27 pts
_LAT_D = (-85, -75, -65) + tuple(range(-55, 60, 5)) + (65, 75)  # 28 pts

# per band: (column longitude, lat pattern) x 8; IGP numbers run 1..201
# through the columns in order (the 85-deg point rotates between bands)
_BAND_COLUMNS = {
    0: ((-180, _LAT_A), (-175, _LAT_B), (-170, _LAT_C), (-165, _LAT_B),
        (-160, _LAT_C), (-155, _LAT_B), (-150, _LAT_C), (-145, _LAT_B)),
    1: ((-140, _LAT_D), (-135, _LAT_B), (-130, _LAT_C), (-125, _LAT_B),
        (-120, _LAT_C), (-115, _LAT_B), (-110, _LAT_C), (-105, _LAT_B)),
    2: ((-100, _LAT_C), (-95, _LAT_B), (-90, _LAT_A), (-85, _LAT_B),
        (-80, _LAT_C), (-75, _LAT_B), (-70, _LAT_C), (-65, _LAT_B)),
    3: ((-60, _LAT_C), (-55, _LAT_B), (-50, _LAT_D), (-45, _LAT_B),
        (-40, _LAT_C), (-35, _LAT_B), (-30, _LAT_C), (-25, _LAT_B)),
    4: ((-20, _LAT_C), (-15, _LAT_B), (-10, _LAT_C), (-5, _LAT_B),
        (0, _LAT_A), (5, _LAT_B), (10, _LAT_C), (15, _LAT_B)),
    5: ((20, _LAT_C), (25, _LAT_B), (30, _LAT_C), (35, _LAT_B),
        (40, _LAT_D), (45, _LAT_B), (50, _LAT_C), (55, _LAT_B)),
    6: ((60, _LAT_C), (65, _LAT_B), (70, _LAT_C), (75, _LAT_B),
        (80, _LAT_C), (85, _LAT_B), (90, _LAT_A), (95, _LAT_B)),
    7: ((100, _LAT_C), (105, _LAT_B), (110, _LAT_C), (115, _LAT_B),
        (120, _LAT_C), (125, _LAT_B), (130, _LAT_D), (135, _LAT_B)),
    8: ((140, _LAT_C), (145, _LAT_B), (150, _LAT_C), (155, _LAT_B),
        (160, _LAT_C), (165, _LAT_B), (170, _LAT_C), (175, _LAT_B)),
}


def igp_location(band: int, igp: int) -> tuple[float, float] | None:
    """(lat_deg, lon_deg) of IGP number ``igp`` (1-based) in ``band`` 0-8,
    or None if out of range (polar bands 9-10 not supported)."""
    cols = _BAND_COLUMNS.get(band)
    if cols is None:
        return None
    n = igp
    for lon, lats in cols:
        if n <= len(lats):
            return float(lats[n - 1]), float(lon)
        n -= len(lats)
    return None


_RE_KM = 6378.1363
_HION_KM = 350.0


def pierce_point(lat_rad: float, lon_rad: float, az_rad: float,
                 el_rad: float) -> tuple[float, float, float]:
    """Ionospheric pierce point (DO-229 A.4.4.10.1; rtklib ionppp):
    (lat_pp_rad, lon_pp_rad, obliquity factor)."""
    psi = np.pi / 2.0 - el_rad - np.arcsin(
        _RE_KM / (_RE_KM + _HION_KM) * np.cos(el_rad))
    lat_pp = np.arcsin(np.sin(lat_rad) * np.cos(psi)
                       + np.cos(lat_rad) * np.sin(psi) * np.cos(az_rad))
    lon_pp = lon_rad + np.arcsin(np.sin(psi) * np.sin(az_rad)
                                 / np.cos(lat_pp))
    fpp = 1.0 / np.sqrt(1.0 - (_RE_KM / (_RE_KM + _HION_KM)
                               * np.cos(el_rad)) ** 2)
    return float(lat_pp), float(lon_pp), float(fpp)


class SbasIonoGrid:
    """Collected MT18 masks + MT26 vertical delays -> slant iono delay.

    Reference: rtklib_sbas.cc sbsion_t state + searchigp/sbsioncorr.
    """

    def __init__(self):
        self._mask: dict[int, list[int]] = {}     # band -> igp numbers
        self._delay: dict[tuple[float, float], float] = {}  # (lat,lon)->m

    def update_mask(self, parsed: dict) -> None:
        self._mask[parsed["band"]] = parsed["igps"]

    def update_delays(self, parsed: dict) -> None:
        band = parsed["band"]
        igps = self._mask.get(band, [])
        base = parsed["block"] * 15
        for k, (delay, _give) in enumerate(parsed["delays"]):
            idx = base + k
            if idx >= len(igps) or delay is None:
                continue
            loc = igp_location(band, igps[idx])
            if loc is not None:
                self._delay[loc] = delay

    @property
    def n_points(self) -> int:
        return len(self._delay)

    def vertical_delay(self, lat_deg: float, lon_deg: float) -> float | None:
        """Bilinear interpolation over the 5x5-deg cell containing the
        pierce point (DO-229 A.4.4.10.3; 10-deg cells above 55 deg are not
        handled — mid-latitude service area)."""
        la0 = np.floor(lat_deg / 5.0) * 5.0
        lo0 = np.floor(lon_deg / 5.0) * 5.0
        corners = []
        for dla, dlo in ((0, 0), (0, 5), (5, 0), (5, 5)):
            lo = ((lo0 + dlo + 180.0) % 360.0) - 180.0
            d = self._delay.get((la0 + dla, lo))
            corners.append(d)
        if any(c is None for c in corners):
            return None
        x = (lon_deg - lo0) / 5.0
        y = (lat_deg - la0) / 5.0
        return ((1 - x) * (1 - y) * corners[0] + x * (1 - y) * corners[1]
                + (1 - x) * y * corners[2] + x * y * corners[3])

    def slant_delay(self, lat_rad: float, lon_rad: float, az_rad: float,
                    el_rad: float) -> float | None:
        """Slant L1 iono delay [m] at the receiver for one satellite, or
        None when the pierce point is not covered by the grid
        (reference sbsioncorr: vertical x obliquity)."""
        lat_pp, lon_pp, fpp = pierce_point(lat_rad, lon_rad, az_rad, el_rad)
        v = self.vertical_delay(np.degrees(lat_pp), np.degrees(lon_pp))
        return None if v is None else fpp * v


# ---------------------------------------------------------------------------
# Type 9: GEO navigation message (DO-229 A.4.4.11, Table A-19) — the SBAS
# satellite's own ECEF state vector + clock, the payload the reference's
# rtklib_sbas.cc sbsdecodemsg stores as seph and the RINEX printer writes
# as 'S' navigation records.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SbasGeoEphemeris:
    """GEO state vector at epoch t0 (seconds of day) + aGf clock terms."""

    prn: int = 120
    iodn: int = 0
    t0_s: float = 0.0           # time of applicability, s of day (LSB 16 s)
    ura: int = 2
    pos_m: tuple = (0.0, 0.0, 0.0)
    vel_m_s: tuple = (0.0, 0.0, 0.0)
    acc_m_s2: tuple = (0.0, 0.0, 0.0)
    agf0_s: float = 0.0         # clock offset, 2^-31 s LSB
    agf1_s_s: float = 0.0       # clock drift, 2^-40 s/s LSB

    def position_velocity(self, t_s: float):
        """Constant-acceleration propagation from t0 (DO-229 A.4.4.11)."""
        dt = t_s - self.t0_s
        p = np.asarray(self.pos_m, np.float64)
        v = np.asarray(self.vel_m_s, np.float64)
        a = np.asarray(self.acc_m_s2, np.float64)
        return p + v * dt + 0.5 * a * dt * dt, v + a * dt

    def clock_offset(self, t_s: float) -> float:
        return self.agf0_s + self.agf1_s_s * (t_s - self.t0_s)


def encode_type9_geo_nav(eph: SbasGeoEphemeris) -> np.ndarray:
    """212 data bits of an MT9 GEO navigation message."""
    def q(v, lsb, n, signed=True):
        x = int(round(v / lsb))
        return _s2b(x, n) if signed else _u2b(x, n)

    return np.concatenate([
        _u2b(eph.iodn & 0xFF, 8),
        _u2b(int(round(eph.t0_s / 16.0)), 13),
        _u2b(eph.ura & 0xF, 4),
        q(eph.pos_m[0], 0.08, 30), q(eph.pos_m[1], 0.08, 30),
        q(eph.pos_m[2], 0.4, 25),
        q(eph.vel_m_s[0], 0.000625, 17), q(eph.vel_m_s[1], 0.000625, 17),
        q(eph.vel_m_s[2], 0.004, 18),
        q(eph.acc_m_s2[0], 0.0000125, 10), q(eph.acc_m_s2[1], 0.0000125, 10),
        q(eph.acc_m_s2[2], 0.0000625, 10),
        q(eph.agf0_s, 2.0 ** -31, 12), q(eph.agf1_s_s, 2.0 ** -40, 8),
    ])


def parse_type9_geo_nav(data212: np.ndarray, prn: int = 0) -> SbasGeoEphemeris:
    b = np.asarray(data212, np.uint8)
    i = [0]

    def u(n):
        v = _b2u(b[i[0]: i[0] + n]); i[0] += n
        return v

    def s(n):
        v = _b2s(b[i[0]: i[0] + n]); i[0] += n
        return v

    iodn = u(8)
    t0 = u(13) * 16.0
    ura = u(4)
    pos = (s(30) * 0.08, s(30) * 0.08, s(25) * 0.4)
    vel = (s(17) * 0.000625, s(17) * 0.000625, s(18) * 0.004)
    acc = (s(10) * 0.0000125, s(10) * 0.0000125, s(10) * 0.0000625)
    agf0 = s(12) * 2.0 ** -31
    agf1 = s(8) * 2.0 ** -40
    return SbasGeoEphemeris(prn=prn, iodn=iodn, t0_s=t0, ura=ura,
                            pos_m=pos, vel_m_s=vel, acc_m_s2=acc,
                            agf0_s=agf0, agf1_s_s=agf1)
