"""GPS CNAV (L2C / L5) navigation message encoder + decoder (the port's copy
of gnss_sdr_tpu/models/nav/gps_cnav.py).

Decoder fills the role of libswiftcnav's ``cnav_msg.c`` + the reference's
``gps_cnav_navigation_message.cc``; the encoder is the simulation oracle.

Message: 300 bits / 12 s (L2C, 25 bps) or / 6 s (L5, 50 bps):
  preamble(8=10001011) PRN(6) msg_type(6) TOW_count(17, LSB 6 s) alert(1)
  payload(238) CRC-24Q(24)
transmitted through the K=7 r=1/2 convolutional encoder (G1=171, G2=133,
non-inverted, continuous across messages).

Types implemented: 10 + 11 (ephemeris halves, quasi-Keplerian with
delta-A/Adot/delta-n-dot relative parameters), 30 (clock + TGD/ISC + iono),
32 (clock + Earth orientation: polar motion + rates, dUT1 + rate),
33 (clock + UTC: A0/A1/A2, leap seconds + leap event WN_LSF/DN/dtLSF).
Field positions follow IS-GPS-200 section 30.3.3 (cross-checked against the
reference's GPS_CNAV.h tables; positions below are 0-based = ICD - 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.models.ephemeris import (IonoParams,
                                                 KeplerEphemeris, UtcParams)
from gnss_sdr_tpu_torch.models.nav import fec

PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], np.uint8)
PI = 3.1415926535898
A_REF = 26_559_710.0             # m  (IS-GPS-200 30.3.3.1.1)
OMEGA_DOT_REF = -2.6e-9 * PI     # rad/s
MSG_BITS = 300


def _u2b(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _s2b(v: int, n: int) -> np.ndarray:
    if v < -(1 << (n - 1)) or v >= (1 << (n - 1)):
        raise ValueError(f"{v} out of range s{n}")
    return _u2b(v & ((1 << n) - 1), n)


def _b2u(b) -> int:
    v = 0
    for x in b:
        v = (v << 1) | int(x)
    return v


def _b2s(b) -> int:
    v = _b2u(b)
    return v - (1 << len(b)) if v >= (1 << (len(b) - 1)) else v


def _q(value, scale, n, signed=True):
    q = int(round(value / scale))
    return _s2b(q, n) if signed else _u2b(q, n)


@dataclasses.dataclass
class EopParams:
    """CNAV MT32 Earth-orientation parameters (IS-GPS-200 30.3.3.5.1:
    polar motion in arcsec / arcsec/day, UT1-UTC in s / s/day)."""

    t_eop: float = 0.0          # s of week, 2^4 LSB
    pm_x: float = 0.0           # arcsec, 2^-20
    pm_x_dot: float = 0.0       # arcsec/day, 2^-21
    pm_y: float = 0.0           # arcsec, 2^-20
    pm_y_dot: float = 0.0       # arcsec/day, 2^-21
    dut1: float = 0.0           # s, 2^-24
    dut1_dot: float = 0.0       # s/day, 2^-25
    valid: bool = False


def encode_message(mtype: int, prn: int, tow_s: float,
                   eph: KeplerEphemeris, iono: IonoParams | None = None,
                   utc: UtcParams | None = None,
                   eop: EopParams | None = None) -> np.ndarray:
    """One 300-bit CNAV message (information bits, before FEC)."""
    m = np.zeros(MSG_BITS, np.uint8)
    m[0:8] = PREAMBLE
    m[8:14] = _u2b(prn & 0x3F, 6)
    m[14:20] = _u2b(mtype, 6)
    m[20:37] = _u2b(int(tow_s / 6.0) % (1 << 17), 17)
    sc = PI
    if mtype == 10:
        m[38:51] = _u2b(eph.week % 8192, 13)
        m[51:54] = _u2b(eph.health & 7, 3)
        m[54:65] = _u2b(int(eph.toe / 300.0), 11)       # top (reuse toe)
        m[65:70] = _u2b(eph.ura & 0x1F, 5)
        m[70:81] = _u2b(int(eph.toe / 300.0), 11)
        m[81:107] = _q(eph.sqrt_a ** 2 - A_REF, 2.0 ** -9, 26)
        m[107:132] = _q(0.0, 2.0 ** -21, 25)            # A_dot
        m[132:149] = _q(eph.delta_n / sc, 2.0 ** -44, 17)
        m[149:172] = _q(0.0, 2.0 ** -57, 23)            # delta_n_dot
        m[172:205] = _q(eph.m0 / sc, 2.0 ** -32, 33)
        m[205:238] = _q(eph.e, 2.0 ** -34, 33, signed=False)
        m[238:271] = _q(eph.omega / sc, 2.0 ** -32, 33)
    elif mtype == 11:
        m[38:49] = _u2b(int(eph.toe / 300.0), 11)
        m[49:82] = _q(eph.omega0 / sc, 2.0 ** -32, 33)
        m[82:115] = _q(eph.i0 / sc, 2.0 ** -32, 33)
        m[115:132] = _q((eph.omega_dot - OMEGA_DOT_REF) / sc, 2.0 ** -44, 17)
        m[132:147] = _q(eph.idot / sc, 2.0 ** -44, 15)
        m[147:163] = _q(eph.cis, 2.0 ** -30, 16)
        m[163:179] = _q(eph.cic, 2.0 ** -30, 16)
        m[179:203] = _q(eph.crs, 2.0 ** -8, 24)
        m[203:227] = _q(eph.crc, 2.0 ** -8, 24)
        m[227:248] = _q(eph.cus, 2.0 ** -30, 21)
        m[248:269] = _q(eph.cuc, 2.0 ** -30, 21)
    elif mtype == 30:
        m[38:49] = _u2b(int(eph.toe / 300.0), 11)
        m[60:71] = _u2b(int(eph.toc / 300.0), 11)
        m[71:97] = _q(eph.af0, 2.0 ** -35, 26)
        m[97:117] = _q(eph.af1, 2.0 ** -48, 20)
        m[117:127] = _q(eph.af2, 2.0 ** -60, 10)
        m[127:140] = _q(eph.tgd, 2.0 ** -35, 13)
        if iono is not None and iono.valid:
            m[192:200] = _q(iono.alpha[0], 2.0 ** -30, 8)
            m[200:208] = _q(iono.alpha[1], 2.0 ** -27, 8)
            m[208:216] = _q(iono.alpha[2], 2.0 ** -24, 8)
            m[216:224] = _q(iono.alpha[3], 2.0 ** -24, 8)
            m[224:232] = _q(iono.beta[0], 2.0 ** 11, 8)
            m[232:240] = _q(iono.beta[1], 2.0 ** 14, 8)
            m[240:248] = _q(iono.beta[2], 2.0 ** 16, 8)
            m[248:256] = _q(iono.beta[3], 2.0 ** 16, 8)
    elif mtype == 32:
        # clock block shared by every MT3x, then the EOP set
        # (IS-GPS-200 Fig 30-9: t_EOP, PM_X/Y + rates, dUT1 + rate)
        m[38:49] = _u2b(int(eph.toe / 300.0), 11)
        m[60:71] = _u2b(int(eph.toc / 300.0), 11)
        m[71:97] = _q(eph.af0, 2.0 ** -35, 26)
        m[97:117] = _q(eph.af1, 2.0 ** -48, 20)
        m[117:127] = _q(eph.af2, 2.0 ** -60, 10)
        if eop is not None and eop.valid:
            m[127:143] = _q(eop.t_eop, 2.0 ** 4, 16, signed=False)
            m[143:164] = _q(eop.pm_x, 2.0 ** -20, 21)
            m[164:179] = _q(eop.pm_x_dot, 2.0 ** -21, 15)
            m[179:200] = _q(eop.pm_y, 2.0 ** -20, 21)
            m[200:215] = _q(eop.pm_y_dot, 2.0 ** -21, 15)
            m[215:246] = _q(eop.dut1, 2.0 ** -24, 31)
            m[246:265] = _q(eop.dut1_dot, 2.0 ** -25, 19)
    elif mtype == 33:
        # clock block shared by every MT3x (bits 39-127), then the UTC
        # parameter set (GPS_CNAV.h CNAV_A0..CNAV_DELTA_TLSF positions)
        m[38:49] = _u2b(int(eph.toe / 300.0), 11)
        m[60:71] = _u2b(int(eph.toc / 300.0), 11)
        m[71:97] = _q(eph.af0, 2.0 ** -35, 26)
        m[97:117] = _q(eph.af1, 2.0 ** -48, 20)
        m[117:127] = _q(eph.af2, 2.0 ** -60, 10)
        if utc is not None and utc.valid:
            m[127:143] = _q(utc.a0, 2.0 ** -35, 16)
            m[143:156] = _q(utc.a1, 2.0 ** -51, 13)
            m[156:163] = _q(utc.a2, 2.0 ** -68, 7)
            m[163:171] = _s2b(utc.delta_t_ls, 8)
            m[171:187] = _q(utc.tot, 2.0 ** 4, 16, signed=False)
            m[187:200] = _u2b(utc.wnt & 0x1FFF, 13)
            m[200:213] = _u2b(utc.wn_lsf & 0x1FFF, 13)
            m[213:217] = _u2b(utc.dn & 0xF, 4)
            m[217:225] = _s2b(utc.delta_t_lsf, 8)
    crc = fec.crc24q_bits(m[:276])
    m[276:300] = _u2b(crc, 24)
    return m


def decode_message(m: np.ndarray) -> tuple[int, int, float, dict] | None:
    """300 info bits -> (msg_type, prn, tow_s, fields) or None on bad CRC."""
    if not np.array_equal(m[0:8], PREAMBLE):
        return None
    if fec.crc24q_bits(m[:276]) != _b2u(m[276:300]):
        return None
    prn = _b2u(m[8:14])
    mtype = _b2u(m[14:20])
    tow = _b2u(m[20:37]) * 6.0
    sc = PI
    f: dict = {}
    if mtype == 10:
        f["week"] = _b2u(m[38:51])
        f["health"] = _b2u(m[51:54])
        f["ura"] = _b2u(m[65:70])
        f["toe"] = _b2u(m[70:81]) * 300.0
        f["sqrt_a"] = np.sqrt(A_REF + _b2s(m[81:107]) * 2.0 ** -9)
        f["delta_n"] = _b2s(m[132:149]) * 2.0 ** -44 * sc
        f["m0"] = _b2s(m[172:205]) * 2.0 ** -32 * sc
        f["e"] = _b2u(m[205:238]) * 2.0 ** -34
        f["omega"] = _b2s(m[238:271]) * 2.0 ** -32 * sc
    elif mtype == 11:
        f["toe"] = _b2u(m[38:49]) * 300.0
        f["omega0"] = _b2s(m[49:82]) * 2.0 ** -32 * sc
        f["i0"] = _b2s(m[82:115]) * 2.0 ** -32 * sc
        f["omega_dot"] = _b2s(m[115:132]) * 2.0 ** -44 * sc + OMEGA_DOT_REF
        f["idot"] = _b2s(m[132:147]) * 2.0 ** -44 * sc
        f["cis"] = _b2s(m[147:163]) * 2.0 ** -30
        f["cic"] = _b2s(m[163:179]) * 2.0 ** -30
        f["crs"] = _b2s(m[179:203]) * 2.0 ** -8
        f["crc"] = _b2s(m[203:227]) * 2.0 ** -8
        f["cus"] = _b2s(m[227:248]) * 2.0 ** -30
        f["cuc"] = _b2s(m[248:269]) * 2.0 ** -30
    elif mtype == 30:
        f["toc"] = _b2u(m[60:71]) * 300.0
        f["af0"] = _b2s(m[71:97]) * 2.0 ** -35
        f["af1"] = _b2s(m[97:117]) * 2.0 ** -48
        f["af2"] = _b2s(m[117:127]) * 2.0 ** -60
        f["tgd"] = _b2s(m[127:140]) * 2.0 ** -35
        f["iono_alpha"] = (_b2s(m[192:200]) * 2.0 ** -30,
                           _b2s(m[200:208]) * 2.0 ** -27,
                           _b2s(m[208:216]) * 2.0 ** -24,
                           _b2s(m[216:224]) * 2.0 ** -24)
        f["iono_beta"] = (_b2s(m[224:232]) * 2.0 ** 11,
                          _b2s(m[232:240]) * 2.0 ** 14,
                          _b2s(m[240:248]) * 2.0 ** 16,
                          _b2s(m[248:256]) * 2.0 ** 16)
    elif mtype == 32:
        f["toc"] = _b2u(m[60:71]) * 300.0
        f["af0"] = _b2s(m[71:97]) * 2.0 ** -35
        f["af1"] = _b2s(m[97:117]) * 2.0 ** -48
        f["af2"] = _b2s(m[117:127]) * 2.0 ** -60
        f["t_eop"] = _b2u(m[127:143]) * 2.0 ** 4
        f["pm_x"] = _b2s(m[143:164]) * 2.0 ** -20
        f["pm_x_dot"] = _b2s(m[164:179]) * 2.0 ** -21
        f["pm_y"] = _b2s(m[179:200]) * 2.0 ** -20
        f["pm_y_dot"] = _b2s(m[200:215]) * 2.0 ** -21
        f["dut1"] = _b2s(m[215:246]) * 2.0 ** -24
        f["dut1_dot"] = _b2s(m[246:265]) * 2.0 ** -25
    elif mtype == 33:
        f["toc"] = _b2u(m[60:71]) * 300.0
        f["af0"] = _b2s(m[71:97]) * 2.0 ** -35
        f["af1"] = _b2s(m[97:117]) * 2.0 ** -48
        f["af2"] = _b2s(m[117:127]) * 2.0 ** -60
        f["utc_a0"] = _b2s(m[127:143]) * 2.0 ** -35
        f["utc_a1"] = _b2s(m[143:156]) * 2.0 ** -51
        f["utc_a2"] = _b2s(m[156:163]) * 2.0 ** -68
        f["delta_t_ls"] = _b2s(m[163:171])
        f["utc_tot"] = _b2u(m[171:187]) * 2.0 ** 4
        f["utc_wnt"] = _b2u(m[187:200])
        f["wn_lsf"] = _b2u(m[200:213])
        f["dn"] = _b2u(m[213:217])
        f["delta_t_lsf"] = _b2s(m[217:225])
    return mtype, prn, tow, f


def encode_symbol_stream(eph: KeplerEphemeris, tow_start_s: float,
                         n_messages: int,
                         iono: IonoParams | None = None,
                         utc: UtcParams | None = None,
                         eop: EopParams | None = None,
                         period_s: float = 12.0) -> np.ndarray:
    """Continuous FEC-encoded symbol stream cycling messages 10, 11, 30
    (and 33 when a UTC set is supplied — the broadcast schedule
    interleaves the MT3x varieties on the same slot).

    The convolutional encoder runs continuously across messages (IS-GPS-200:
    the L2C/L5 FEC is not reset per message); message k starts at
    tow_start_s + k * period_s — 12 s on L2C (25 bps), 6 s on L5 (50 bps,
    reference gps_l5_telemetry_decoder_gs.cc).
    """
    types = [10, 11, 30]
    if eop is not None:
        types.append(32)
    if utc is not None:
        types.append(33)
    bits = []
    for k in range(n_messages):
        mt = types[k % len(types)]
        # IS-GPS-200: the CNAV TOW count tags the start of the NEXT message
        bits.append(encode_message(
            mt, eph.prn, tow_start_s + period_s * (k + 1), eph, iono, utc,
            eop))
    all_bits = np.concatenate(bits)
    return fec.conv_encode(all_bits, invert_g2=False, flush=True)


class CnavAssembler:
    """Collects messages 10/11/30 into a KeplerEphemeris and harvests
    the MT30 iono, MT32 EOP and MT33 UTC parameter sets."""

    def __init__(self, prn: int):
        self.prn = prn
        self.msgs: dict[int, dict] = {}
        self.iono = IonoParams()
        self.utc = UtcParams()
        self.eop = EopParams()

    def push(self, mtype: int, fields: dict) -> None:
        self.msgs[mtype] = fields
        if mtype == 30 and "iono_alpha" in fields:
            self.iono = IonoParams(alpha=fields["iono_alpha"],
                                   beta=fields["iono_beta"], valid=True)
        if mtype == 32 and "t_eop" in fields:
            self.eop = EopParams(
                t_eop=fields["t_eop"], pm_x=fields["pm_x"],
                pm_x_dot=fields["pm_x_dot"], pm_y=fields["pm_y"],
                pm_y_dot=fields["pm_y_dot"], dut1=fields["dut1"],
                dut1_dot=fields["dut1_dot"], valid=True)
        if mtype == 33 and "utc_a0" in fields:
            self.utc = UtcParams(
                a0=fields["utc_a0"], a1=fields["utc_a1"],
                a2=fields["utc_a2"], tot=fields["utc_tot"],
                wnt=fields["utc_wnt"], delta_t_ls=fields["delta_t_ls"],
                wn_lsf=fields["wn_lsf"], dn=fields["dn"],
                delta_t_lsf=fields["delta_t_lsf"], valid=True)

    def ephemeris(self) -> KeplerEphemeris | None:
        if not all(k in self.msgs for k in (10, 11, 30)):
            return None
        m10, m11, m30 = self.msgs[10], self.msgs[11], self.msgs[30]
        if m10["toe"] != m11["toe"]:
            return None
        return KeplerEphemeris(
            prn=self.prn, week=m10["week"], health=m10["health"],
            ura=m10["ura"], toe=m10["toe"], sqrt_a=m10["sqrt_a"],
            delta_n=m10["delta_n"], m0=m10["m0"], e=m10["e"],
            omega=m10["omega"],
            omega0=m11["omega0"], i0=m11["i0"], omega_dot=m11["omega_dot"],
            idot=m11["idot"], cis=m11["cis"], cic=m11["cic"],
            crs=m11["crs"], crc=m11["crc"], cus=m11["cus"], cuc=m11["cuc"],
            toc=m30["toc"], af0=m30["af0"], af1=m30["af1"], af2=m30["af2"],
            tgd=m30["tgd"], iode=int(m10["toe"] / 300) & 0xFF,
        )
