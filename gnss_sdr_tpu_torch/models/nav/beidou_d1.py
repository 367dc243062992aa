"""BeiDou B1I/B3I D1 navigation message encoder + decoder (the PyTorch
port's copy of gnss_sdr_tpu/models/nav/beidou_d1.py).

Decoder fills the role of the reference's
``beidou_dnav_navigation_message.cc`` + ``beidou_b1i_telemetry_decoder_gs``
(NH-code stripping is handled upstream; here: BCH(15,11) de-interleave/check
and subframe field extraction); the encoder is the simulation oracle.

D1 frame (BDS ICD 5.1): 5 subframes x 300 bits at 50 bps (modulated by the
NH20 secondary code at the ranging-code layer). Each 30-bit word: word 1 =
15 raw bits (11-bit preamble 11100100010 + 4) + BCH(15,11); words 2-10 = two
bit-interleaved BCH(15,11) codewords (22 info + 8 parity). Field positions
are 1-based indices into the 300-bit subframe with parity regions skipped
(split tuples), matching the reference's Beidou_DNAV.h tables.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, KeplerEphemeris
from gnss_sdr_tpu_torch import constants as C

PREAMBLE = np.array([1, 1, 1, 0, 0, 1, 0, 0, 0, 1, 0], np.uint8)
PI = 3.1415926535898

# BCH(15,11) with g(x) = x^4 + x + 1
_BCH_G = 0b10011


def _bch15_encode(info11: np.ndarray) -> np.ndarray:
    reg = 0
    for b in info11:
        reg = ((reg << 1) | int(b)) & 0x7FFF
    reg <<= 4
    # polynomial division
    for i in range(14, 3, -1):
        if reg & (1 << i):
            reg ^= _BCH_G << (i - 4)
    parity = reg & 0xF
    return np.concatenate([info11, [(parity >> 3) & 1, (parity >> 2) & 1,
                                    (parity >> 1) & 1, parity & 1]]).astype(np.uint8)


def _bch15_check(word15: np.ndarray) -> bool:
    reg = 0
    for b in word15:
        reg = (reg << 1) | int(b)
    for i in range(14, 3, -1):
        if reg & (1 << i):
            reg ^= _BCH_G << (i - 4)
    return (reg & 0xF) == 0


def encode_word(info: np.ndarray, first: bool) -> np.ndarray:
    """Info bits -> 30-bit transmitted word."""
    if first:
        assert len(info) == 26
        return np.concatenate([info[:15], _bch15_encode(info[15:26])])
    assert len(info) == 22
    a = _bch15_encode(info[:11])
    b = _bch15_encode(info[11:22])
    out = np.empty(30, np.uint8)
    out[0::2] = a
    out[1::2] = b
    return out


def decode_word(word30: np.ndarray, first: bool) -> np.ndarray | None:
    if first:
        if not _bch15_check(word30[15:30]):
            return None
        return np.concatenate([word30[:15], word30[15:26]])
    a = word30[0::2]
    b = word30[1::2]
    if not (_bch15_check(a) and _bch15_check(b)):
        return None
    return np.concatenate([a[:11], b[:11]])


def _u2b(v, n):
    return np.array([(int(v) >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _b2u(b):
    v = 0
    for x in b:
        v = (v << 1) | int(x)
    return v


def _b2s(b):
    v = _b2u(b)
    return v - (1 << len(b)) if v >= (1 << (len(b) - 1)) else v


# field position tables: (subframe-relative 1-based raw positions, width)
# pairs; parity regions are skipped by the splits (BDS ICD / Beidou_DNAV.h)
_SF1 = {
    "sat_h1": ([(43, 1)], 1, 0),
    "aodc": ([(44, 5)], 0, 0),
    "urai": ([(49, 4)], 0, 0),
    "wn": ([(61, 13)], 0, 0),
    "toc": ([(74, 9), (91, 8)], 0, 2.0 ** 3),
    "tgd1": ([(99, 10)], 1, 0.1e-9),
    "alpha0": ([(127, 8)], 1, 2.0 ** -30),
    "alpha1": ([(135, 8)], 1, 2.0 ** -27),
    "alpha2": ([(151, 8)], 1, 2.0 ** -24),
    "alpha3": ([(159, 8)], 1, 2.0 ** -24),
    "beta0": ([(167, 6), (181, 2)], 1, 2.0 ** 11),
    "beta1": ([(183, 8)], 1, 2.0 ** 14),
    "beta2": ([(191, 8)], 1, 2.0 ** 16),
    "beta3": ([(199, 4), (211, 4)], 1, 2.0 ** 16),
    "af2": ([(215, 11)], 1, 2.0 ** -66),
    "af0": ([(226, 7), (241, 17)], 1, 2.0 ** -33),
    "af1": ([(258, 5), (271, 17)], 1, 2.0 ** -50),
    "aode": ([(288, 5)], 0, 0),
}
_SF2 = {
    "delta_n": ([(43, 10), (61, 6)], 1, PI * 2.0 ** -43),
    "cuc": ([(67, 16), (91, 2)], 1, 2.0 ** -31),
    "m0": ([(93, 20), (121, 12)], 1, PI * 2.0 ** -31),
    "e": ([(133, 10), (151, 22)], 0, 2.0 ** -33),
    "cus": ([(181, 18)], 1, 2.0 ** -31),
    "crc": ([(199, 4), (211, 14)], 1, 2.0 ** -6),
    "crs": ([(225, 8), (241, 10)], 1, 2.0 ** -6),
    "sqrt_a": ([(251, 12), (271, 20)], 0, 2.0 ** -19),
    "toe_msb": ([(291, 2)], 0, 0),
}
_SF3 = {
    "toe_lsb": ([(43, 10), (61, 5)], 0, 0),
    "i0": ([(66, 17), (91, 15)], 1, PI * 2.0 ** -31),
    "cic": ([(106, 7), (121, 11)], 1, 2.0 ** -31),
    "omega_dot": ([(132, 11), (151, 13)], 1, PI * 2.0 ** -43),
    "cis": ([(164, 9), (181, 9)], 1, 2.0 ** -31),
    "idot": ([(190, 13), (211, 1)], 1, PI * 2.0 ** -43),
    "omega0": ([(212, 21), (241, 11)], 1, PI * 2.0 ** -31),
    "omega": ([(252, 11), (271, 21)], 1, PI * 2.0 ** -31),
}
# subframe 4 (all pages) and subframe 5 pages 1-6: one almanac per page
# (BDS ICD 5.2.4.14; Beidou_DNAV.h D1_*_ALMANAC tables)
_SFALM = {
    "pnum": ([(44, 7)], 0, 0),
    "sqrt_a": ([(51, 2), (61, 22)], 0, 2.0 ** -11),
    "af1": ([(91, 11)], 1, 2.0 ** -38),
    "af0": ([(102, 11)], 1, 2.0 ** -20),
    "omega0": ([(121, 22), (151, 2)], 1, PI * 2.0 ** -23),
    "e": ([(153, 17)], 0, 2.0 ** -21),
    "delta_i": ([(170, 3), (181, 13)], 1, PI * 2.0 ** -19),
    "toa": ([(194, 8)], 0, 2.0 ** 12),
    "omega_dot": ([(202, 1), (211, 16)], 1, PI * 2.0 ** -38),
    "omega": ([(227, 6), (241, 18)], 1, PI * 2.0 ** -23),
    "m0": ([(259, 4), (271, 20)], 1, PI * 2.0 ** -23),
}
# subframe 5 page 7: satellite health SV 1-19 (9-bit words)
_SF5P7 = {
    "pnum": ([(44, 7)], 0, 0),
    "hea1": ([(51, 2), (61, 7)], 0, 0),
    "hea2": ([(68, 9)], 0, 0),
    "hea3": ([(77, 6), (91, 3)], 0, 0),
    "hea4": ([(94, 9)], 0, 0),
    "hea5": ([(103, 9)], 0, 0),
    "hea6": ([(112, 1), (121, 8)], 0, 0),
    "hea7": ([(129, 9)], 0, 0),
    "hea8": ([(138, 5), (151, 4)], 0, 0),
    "hea9": ([(155, 9)], 0, 0),
    "hea10": ([(164, 9)], 0, 0),
    "hea11": ([(181, 9)], 0, 0),
    "hea12": ([(190, 9)], 0, 0),
    "hea13": ([(199, 4), (211, 5)], 0, 0),
    "hea14": ([(216, 9)], 0, 0),
    "hea15": ([(225, 8), (241, 1)], 0, 0),
    "hea16": ([(242, 9)], 0, 0),
    "hea17": ([(251, 9)], 0, 0),
    "hea18": ([(260, 3), (271, 6)], 0, 0),
    "hea19": ([(277, 9)], 0, 0),
}
# subframe 5 page 8: health SV 20-30 + almanac reference week/time
_SF5P8 = {
    "pnum": ([(44, 7)], 0, 0),
    "hea20": ([(51, 2), (61, 7)], 0, 0),
    "hea21": ([(68, 9)], 0, 0),
    "hea22": ([(77, 6), (91, 3)], 0, 0),
    "hea23": ([(94, 9)], 0, 0),
    "hea24": ([(103, 9)], 0, 0),
    "hea25": ([(112, 1), (121, 8)], 0, 0),
    "hea26": ([(129, 9)], 0, 0),
    "hea27": ([(138, 5), (151, 4)], 0, 0),
    "hea28": ([(155, 9)], 0, 0),
    "hea29": ([(164, 9)], 0, 0),
    "hea30": ([(181, 9)], 0, 0),
    "wna": ([(190, 8)], 0, 0),
    "toa2": ([(198, 5), (211, 3)], 0, 2.0 ** 12),
}
_TABLES = {1: _SF1, 2: _SF2, 3: _SF3}


def _info_positions(sf_bits: np.ndarray):
    """View helper: sf_bits is the RAW 300-bit subframe; fields address raw
    positions but never fall into parity regions."""
    return sf_bits


def _place(sf: np.ndarray, spec, value_int: int) -> None:
    total = sum(w for _, w in spec)
    bits = _u2b(value_int & ((1 << total) - 1), total)
    i = 0
    for pos, w in spec:
        sf[pos - 1: pos - 1 + w] = bits[i: i + w]
        i += w


def _extract(sf: np.ndarray, spec, signed: bool) -> int:
    bits = np.concatenate([sf[pos - 1: pos - 1 + w] for pos, w in spec])
    return _b2s(bits) if signed else _b2u(bits)


def encode_subframe(fraid: int, sow_s: float, eph: KeplerEphemeris,
                    iono: IonoParams | None = None) -> np.ndarray:
    """One 300-bit D1 subframe (transmitted bits, parity filled)."""
    sf = np.zeros(300, np.uint8)
    sf[0:11] = PREAMBLE
    _place(sf, [(16, 3)], fraid)
    sow = int(sow_s) % 604800
    _place(sf, [(19, 8), (31, 12)], sow)

    vals: dict[str, float] = {}
    if fraid == 1:
        vals = dict(sat_h1=eph.health & 1, aodc=eph.iodc & 31, urai=eph.ura & 15,
                    wn=eph.week % 8192, toc=eph.toc, tgd1=eph.tgd,
                    af2=eph.af2, af0=eph.af0, af1=eph.af1, aode=eph.iode & 31)
        if iono is not None and iono.valid:
            for i in range(4):
                vals[f"alpha{i}"] = iono.alpha[i]
                vals[f"beta{i}"] = iono.beta[i]
    elif fraid == 2:
        vals = dict(delta_n=eph.delta_n, cuc=eph.cuc, m0=eph.m0,
                    e=eph.e, cus=eph.cus, crc=eph.crc, crs=eph.crs,
                    sqrt_a=eph.sqrt_a, toe_msb=(int(eph.toe / 8.0) >> 15) & 3)
    elif fraid == 3:
        vals = dict(toe_lsb=int(eph.toe / 8.0) & 0x7FFF, i0=eph.i0,
                    cic=eph.cic, omega_dot=eph.omega_dot, cis=eph.cis,
                    idot=eph.idot, omega0=eph.omega0, omega=eph.omega)
    table = _TABLES.get(fraid, {})
    for name, (spec, signed, lsb) in table.items():
        if name not in vals:
            continue
        v = vals[name]
        q = int(round(v / lsb)) if lsb else int(v)
        _place(sf, spec, q)

    # encode words: word 1 = 15 raw + BCH(15,11); words 2-10 = the 22 info
    # bits at [w*30, w*30+22) in the de-interleaved layout, transmitted as
    # two bit-interleaved BCH(15,11) codewords
    out = sf.copy()
    out[0:30] = encode_word(sf[0:26], first=True)
    for w in range(1, 10):
        out[w * 30: (w + 1) * 30] = encode_word(sf[w * 30: w * 30 + 22],
                                                first=False)
    return out


def encode_almanac_page(fraid: int, sow_s: float, alm,
                        pnum: int) -> np.ndarray:
    """One SF4 (pages 1-24, SV=pnum) or SF5 (pages 1-6, SV=24+pnum) almanac
    subframe (reference beidou_dnav_navigation_message.cc cases 4/5)."""
    sf = np.zeros(300, np.uint8)
    sf[0:11] = PREAMBLE
    _place(sf, [(16, 3)], fraid)
    _place(sf, [(19, 8), (31, 12)], int(sow_s) % 604800)
    vals = dict(pnum=pnum, sqrt_a=alm.sqrt_a, af1=alm.af1, af0=alm.af0,
                omega0=alm.omega0, e=alm.e, delta_i=alm.delta_i,
                toa=alm.toa, omega_dot=alm.omega_dot, omega=alm.omega,
                m0=alm.m0)
    for name, (spec, signed, lsb) in _SFALM.items():
        v = vals[name]
        q = int(round(v / lsb)) if lsb else int(v)
        _place(sf, spec, q)
    return _finish_subframe(sf)


def _finish_subframe(sf: np.ndarray) -> np.ndarray:
    out = sf.copy()
    out[0:30] = encode_word(sf[0:26], first=True)
    for w in range(1, 10):
        out[w * 30: (w + 1) * 30] = encode_word(sf[w * 30: w * 30 + 22],
                                                first=False)
    return out


def encode_almanac_reference_page(sow_s: float, toa: float, wna: int,
                                  healths: dict | None = None) -> np.ndarray:
    """SF5 page 8: almanac reference week + time, health SV 20-30
    (``healths`` keyed by SV number; omitted SVs read 0 = healthy)."""
    sf = np.zeros(300, np.uint8)
    sf[0:11] = PREAMBLE
    _place(sf, [(16, 3)], 5)
    _place(sf, [(19, 8), (31, 12)], int(sow_s) % 604800)
    _place(sf, _SF5P8["pnum"][0], 8)
    for sv in range(20, 31):
        _place(sf, _SF5P8[f"hea{sv}"][0], (healths or {}).get(sv, 0) & 0x1FF)
    _place(sf, _SF5P8["wna"][0], wna & 0xFF)
    _place(sf, _SF5P8["toa2"][0], int(toa / 4096.0) & 0xFF)
    return _finish_subframe(sf)


def encode_health_page(sow_s: float, healths: dict | None = None
                       ) -> np.ndarray:
    """SF5 page 7: satellite health SV 1-19 (BDS ICD 5.2.4.16)."""
    sf = np.zeros(300, np.uint8)
    sf[0:11] = PREAMBLE
    _place(sf, [(16, 3)], 5)
    _place(sf, [(19, 8), (31, 12)], int(sow_s) % 604800)
    _place(sf, _SF5P7["pnum"][0], 7)
    for sv in range(1, 20):
        _place(sf, _SF5P7[f"hea{sv}"][0], (healths or {}).get(sv, 0) & 0x1FF)
    return _finish_subframe(sf)


def decode_subframe(tx: np.ndarray) -> tuple[int, float, dict] | None:
    """300 transmitted bits -> (fraid, sow, fields) or None."""
    if not np.array_equal(tx[0:11], PREAMBLE):
        return None
    sf = np.zeros(300, np.uint8)
    w0 = decode_word(tx[0:30], first=True)
    if w0 is None:
        return None
    sf[0:26] = w0
    for w in range(1, 10):
        info = decode_word(tx[w * 30: (w + 1) * 30], first=False)
        if info is None:
            return None
        sf[w * 30: w * 30 + 22] = info
    fraid = _extract(sf, [(16, 3)], False)
    sow = float(_extract(sf, [(19, 8), (31, 12)], False))
    f: dict = {}
    if fraid in (4, 5):
        pnum = _extract(sf, _SFALM["pnum"][0], False)
        if fraid == 5 and pnum == 7:
            table = _SF5P7
        elif fraid == 5 and pnum == 8:
            table = _SF5P8
        elif fraid == 4 or pnum <= 6:
            table = _SFALM
        else:
            table = {"pnum": _SFALM["pnum"]}
    else:
        table = _TABLES.get(fraid)
    if table:
        for name, (spec, signed, lsb) in table.items():
            q = _extract(sf, spec, bool(signed))
            f[name] = q * lsb if lsb else q
    return fraid, sow, f


class D1Assembler:
    def __init__(self, prn: int):
        self.prn = prn
        self.sf: dict[int, dict] = {}
        self.iono = IonoParams()
        # constellation almanac from SF4 (SV 1-24) / SF5 pages 1-6
        # (SV 25-30), keyed by the almanac's own SV; SF5 page 8 carries the
        # reference week applied to all collected records
        self.almanacs: dict[int, object] = {}
        self.alm_wna: int | None = None
        self.alm_toa: float | None = None
        self.health: dict[int, int] = {}   # SV -> 9-bit health word

    def push(self, fraid: int, fields: dict) -> None:
        if fraid in (4, 5):
            self._push_almanac(fraid, fields)
            return
        self.sf[fraid] = fields
        if fraid == 1 and "alpha0" in fields:
            self.iono = IonoParams(
                alpha=tuple(fields[f"alpha{i}"] for i in range(4)),
                beta=tuple(fields[f"beta{i}"] for i in range(4)), valid=True)

    def _push_almanac(self, fraid: int, fields: dict) -> None:
        from gnss_sdr_tpu_torch.models.almanac import BeidouAlmanac
        pnum = int(fields.get("pnum", 0))
        if fraid == 5 and pnum == 7:
            for sv in range(1, 20):
                self.health[sv] = int(fields.get(f"hea{sv}", 0))
            self._apply_health()
            return
        if fraid == 5 and pnum == 8:
            self.alm_wna = int(fields["wna"])
            self.alm_toa = float(fields["toa2"])
            for sv in range(20, 31):
                self.health[sv] = int(fields.get(f"hea{sv}", 0))
            for a in self.almanacs.values():
                a.wna = self.alm_wna
            self._apply_health()
            return
        if "sqrt_a" not in fields or fields["sqrt_a"] <= 0.0:
            return  # empty/reserved page
        sv = pnum if fraid == 4 else 24 + pnum
        self.almanacs[sv] = BeidouAlmanac(
            prn=sv, sqrt_a=fields["sqrt_a"], e=fields["e"],
            delta_i=fields["delta_i"], toa=fields["toa"],
            omega0=fields["omega0"], omega=fields["omega"],
            m0=fields["m0"], omega_dot=fields["omega_dot"],
            af0=fields["af0"], af1=fields["af1"],
            wna=self.alm_wna or 0, health=self.health.get(sv, 0))

    def _apply_health(self) -> None:
        for sv, a in self.almanacs.items():
            a.health = self.health.get(sv, 0)

    def ephemeris(self) -> KeplerEphemeris | None:
        if not all(k in self.sf for k in (1, 2, 3)):
            return None
        s1, s2, s3 = self.sf[1], self.sf[2], self.sf[3]
        toe = (int(s2["toe_msb"]) << 15 | int(s3["toe_lsb"])) * 8.0
        return KeplerEphemeris(
            prn=self.prn, week=int(s1["wn"]), toc=s1["toc"], af0=s1["af0"],
            af1=s1["af1"], af2=s1["af2"], tgd=s1["tgd1"],
            health=int(s1["sat_h1"]), ura=int(s1["urai"]),
            iodc=int(s1["aodc"]), iode=int(s1["aode"]),
            delta_n=s2["delta_n"], cuc=s2["cuc"], m0=s2["m0"], e=s2["e"],
            cus=s2["cus"], crc=s2["crc"], crs=s2["crs"],
            sqrt_a=s2["sqrt_a"], toe=toe,
            i0=s3["i0"], cic=s3["cic"], omega_dot=s3["omega_dot"],
            cis=s3["cis"], idot=s3["idot"], omega0=s3["omega0"],
            omega=s3["omega"], gm=C.GM_EARTH_BDS,
            omega_e=C.OMEGA_EARTH_DOT,
        )
