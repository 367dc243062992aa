"""Galileo E5a F/NAV message codec (OS SIS ICD v1.3, section 4.2; the
port's copy of gnss_sdr_tpu/models/nav/galileo_fnav.py).

Reference analog: the F/NAV path of
``src/algorithms/telemetry_decoder/gnuradio_blocks/galileo_telemetry_decoder_gs.cc``
(E5a branch: 12-symbol sync, 61x8 deinterleaver, K=7 Viterbi, CRC-24Q) and the
page parsers in ``src/core/system_parameters/galileo_fnav_message.cc``.

Page structure (10 s, 500 symbols at 50 sps on the E5a-I data component):
  [12-symbol sync 101101110000] + interleave_61x8(conv_K7(page 238 bits + 6 tail))
  page bits = type(6) + content(208) = 214, then CRC-24Q(24) over the 214.

Page types implemented: 1 (SVID/clock/iono/BGD), 2 (ephemeris 1/3),
3 (ephemeris 2/3), 4 (Cic/Cis + GST-UTC/GST-GPS). Each page carries WN/TOW
of its own transmission start. Encoder exists for the signal-level simulator
(the QA oracle), mirroring the reference's use of an external generator.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import fec
from gnss_sdr_tpu_torch.models.nav.galileo_inav import _b2s, _b2u, _q, _s2b, _u2b

PI = 3.1415926535898
SYNC = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0], np.uint8)
PAGE_SYMBOLS = 500
PAGE_SECONDS = 10.0
SYMBOL_MS = 20


class _Cursor:
    """Sequential bit packer/unpacker over a fixed-size page."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.pos = 0

    def put(self, field: np.ndarray) -> None:
        n = len(field)
        self.bits[self.pos: self.pos + n] = field
        self.pos += n

    def get(self, n: int) -> np.ndarray:
        f = self.bits[self.pos: self.pos + n]
        self.pos += n
        return f


def encode_page_bits(ptype: int, eph: KeplerEphemeris, *, wn: int = 0,
                     tow: float = 0.0,
                     iono: IonoParams | None = None) -> np.ndarray:
    """One F/NAV page -> 214 nav bits (type + content, before CRC)."""
    bits = np.zeros(214, np.uint8)
    c = _Cursor(bits)
    c.put(_u2b(ptype, 6))
    sc = PI
    if ptype == 1:
        c.put(_u2b(eph.prn & 0x3F, 6))
        c.put(_u2b(eph.iode & 0x3FF, 10))
        c.put(_u2b(int(eph.toc / 60.0), 14))
        c.put(_q(eph.af0, 2.0 ** -34, 31))
        c.put(_q(eph.af1, 2.0 ** -46, 21))
        c.put(_q(eph.af2, 2.0 ** -59, 6))
        c.put(_u2b(eph.ura & 0xFF, 8))                      # SISA
        a = iono.alpha if (iono and iono.valid) else (0.0, 0.0, 0.0, 0.0)
        c.put(_q(a[0], 2.0 ** -2, 11, signed=False))        # ai0
        c.put(_q(a[1], 2.0 ** -8, 11))                      # ai1
        c.put(_q(a[2], 2.0 ** -15, 14))                     # ai2
        c.put(np.zeros(5, np.uint8))                        # region flags
        c.put(_q(eph.tgd, 2.0 ** -32, 10))                  # BGD E1/E5a
        c.put(np.zeros(2, np.uint8))                        # E5a HS
        c.put(_u2b(wn % 4096, 12))
        c.put(_u2b(int(tow) % 604800, 20))
    elif ptype == 2:
        c.put(_u2b(eph.iode & 0x3FF, 10))
        c.put(_q(eph.m0 / sc, 2.0 ** -31, 32))
        c.put(_q(eph.omega_dot / sc, 2.0 ** -43, 24))
        c.put(_q(eph.e, 2.0 ** -33, 32, signed=False))
        c.put(_q(eph.sqrt_a, 2.0 ** -19, 32, signed=False))
        c.put(_q(eph.omega0 / sc, 2.0 ** -31, 32))
        c.put(_q(eph.idot / sc, 2.0 ** -43, 14))
        c.put(_u2b(wn % 4096, 12))
        c.put(_u2b(int(tow) % 604800, 20))
    elif ptype == 3:
        c.put(_u2b(eph.iode & 0x3FF, 10))
        c.put(_q(eph.i0 / sc, 2.0 ** -31, 32))
        c.put(_q(eph.omega / sc, 2.0 ** -31, 32))
        c.put(_q(eph.delta_n / sc, 2.0 ** -43, 16))
        c.put(_q(eph.cuc, 2.0 ** -29, 16))
        c.put(_q(eph.cus, 2.0 ** -29, 16))
        c.put(_q(eph.crc, 2.0 ** -5, 16))
        c.put(_q(eph.crs, 2.0 ** -5, 16))
        c.put(_u2b(int(eph.toe / 60.0), 14))
        c.put(_u2b(wn % 4096, 12))
        c.put(_u2b(int(tow) % 604800, 20))
    elif ptype == 4:
        c.put(_u2b(eph.iode & 0x3FF, 10))
        c.put(_q(eph.cic, 2.0 ** -29, 16))
        c.put(_q(eph.cis, 2.0 ** -29, 16))
        c.put(np.zeros(32 + 24 + 8 + 8 + 8, np.uint8))      # GST-UTC params
        c.put(np.zeros(8 + 3 + 8, np.uint8))                # leap-second plan
        c.put(np.zeros(16 + 12 + 6, np.uint8))              # GST-GPS (GGTO)
        c.put(_u2b(int(tow) % 604800, 20))
    return bits


def decode_page_bits(bits: np.ndarray) -> tuple[int, dict]:
    c = _Cursor(np.asarray(bits, np.uint8))
    ptype = _b2u(c.get(6))
    sc = PI
    f: dict = {}
    if ptype == 1:
        f["svid"] = _b2u(c.get(6))
        f["iod_nav"] = _b2u(c.get(10))
        f["toc"] = _b2u(c.get(14)) * 60.0
        f["af0"] = _b2s(c.get(31)) * 2.0 ** -34
        f["af1"] = _b2s(c.get(21)) * 2.0 ** -46
        f["af2"] = _b2s(c.get(6)) * 2.0 ** -59
        f["sisa"] = _b2u(c.get(8))
        f["ai0"] = _b2u(c.get(11)) * 2.0 ** -2
        f["ai1"] = _b2s(c.get(11)) * 2.0 ** -8
        f["ai2"] = _b2s(c.get(14)) * 2.0 ** -15
        c.get(5)
        f["bgd_e1e5a"] = _b2s(c.get(10)) * 2.0 ** -32
        c.get(2)
        f["wn"] = _b2u(c.get(12))
        f["tow"] = float(_b2u(c.get(20)))
    elif ptype == 2:
        f["iod_nav"] = _b2u(c.get(10))
        f["m0"] = _b2s(c.get(32)) * 2.0 ** -31 * sc
        f["omega_dot"] = _b2s(c.get(24)) * 2.0 ** -43 * sc
        f["e"] = _b2u(c.get(32)) * 2.0 ** -33
        f["sqrt_a"] = _b2u(c.get(32)) * 2.0 ** -19
        f["omega0"] = _b2s(c.get(32)) * 2.0 ** -31 * sc
        f["idot"] = _b2s(c.get(14)) * 2.0 ** -43 * sc
        f["wn"] = _b2u(c.get(12))
        f["tow"] = float(_b2u(c.get(20)))
    elif ptype == 3:
        f["iod_nav"] = _b2u(c.get(10))
        f["i0"] = _b2s(c.get(32)) * 2.0 ** -31 * sc
        f["omega"] = _b2s(c.get(32)) * 2.0 ** -31 * sc
        f["delta_n"] = _b2s(c.get(16)) * 2.0 ** -43 * sc
        f["cuc"] = _b2s(c.get(16)) * 2.0 ** -29
        f["cus"] = _b2s(c.get(16)) * 2.0 ** -29
        f["crc"] = _b2s(c.get(16)) * 2.0 ** -5
        f["crs"] = _b2s(c.get(16)) * 2.0 ** -5
        f["toe"] = _b2u(c.get(14)) * 60.0
        f["wn"] = _b2u(c.get(12))
        f["tow"] = float(_b2u(c.get(20)))
    elif ptype == 4:
        f["iod_nav"] = _b2u(c.get(10))
        f["cic"] = _b2s(c.get(16)) * 2.0 ** -29
        f["cis"] = _b2s(c.get(16)) * 2.0 ** -29
        c.get(32 + 24 + 8 + 8 + 8 + 8 + 3 + 8 + 16 + 12 + 6)
        f["tow"] = float(_b2u(c.get(20)))
    return ptype, f


def encode_page(nav_bits: np.ndarray) -> np.ndarray:
    """214 nav bits -> 500 transmitted symbols (0/1)."""
    crc = fec.crc24q_bits(nav_bits)
    page = np.concatenate([nav_bits, _u2b(crc, 24)]).astype(np.uint8)  # 238
    sym = fec.conv_encode(page, invert_g2=True)            # (238+6)*2 = 488
    sym = fec.block_interleave(sym, 61, 8)
    return np.concatenate([SYNC, sym])


def decode_page(symbols: np.ndarray) -> tuple[int, dict] | None:
    """500 soft symbols (+amp == bit 1, same convention as galileo_inav)
    starting at the sync word -> (page_type, fields) or None.

    The 12-symbol sync resolves the half-cycle polarity ambiguity.
    """
    s = np.asarray(symbols, np.float64)
    sync_pm = 1.0 - 2.0 * SYNC.astype(np.float64)
    corr = float(np.sign(s[:12]) @ (-sync_pm))
    if abs(corr) < 8.0:
        return None
    pol = 1.0 if corr > 0 else -1.0
    body = fec.block_deinterleave(pol * s[12:], 61, 8)
    bits = fec.viterbi_decode(body, 238, invert_g2=True)
    nav, crc_rx = bits[:214], _b2u(bits[214:238])
    if fec.crc24q_bits(nav) != crc_rx:
        return None
    return decode_page_bits(nav)


def encode_stream(eph: KeplerEphemeris, tow_start_s: float, n_pages: int,
                  *, wn: int = 0, iono: IonoParams | None = None,
                  page_offset: int = 0) -> np.ndarray:
    """Cycle page types 1..4; returns [n_pages*500] symbols (0/1).

    Page k starts at GST ``tow_start_s + 10 k`` and carries that TOW.
    ``page_offset`` rotates the type cycle (page k has type
    ((k + page_offset) % 4) + 1) — each page carries its own TOW, so
    simulations can start the useful 1-2-3 ephemeris set right after the
    receiver's first partially-received page.
    """
    out = []
    for k in range(n_pages):
        ptype = ((k + page_offset) % 4) + 1
        tow = tow_start_s + PAGE_SECONDS * k
        out.append(encode_page(encode_page_bits(
            ptype, eph, wn=wn, tow=tow, iono=iono)))
    return np.concatenate(out)


class FnavAssembler:
    """Collects decoded pages into a KeplerEphemeris (IOD-matched 1+2+3,
    Cic/Cis grafted from type 4 when available)."""

    def __init__(self, prn: int):
        self.prn = prn
        self.pages: dict[int, dict] = {}
        self.iono = IonoParams()
        self.wn = 0

    def push(self, ptype: int, fields: dict) -> None:
        self.pages[ptype] = fields
        if "wn" in fields:
            self.wn = fields["wn"]
        if ptype == 1 and "ai0" in fields:
            # NeQuick coefficients reported; stored for completeness (the
            # single-frequency correction uses the Klobuchar model from GPS)
            self.iono = IonoParams(
                alpha=(fields["ai0"], fields["ai1"], fields["ai2"], 0.0),
                beta=(0.0, 0.0, 0.0, 0.0), valid=False)

    def ephemeris(self) -> KeplerEphemeris | None:
        need = (1, 2, 3)
        if not all(t in self.pages for t in need):
            return None
        iods = {self.pages[t]["iod_nav"] for t in need}
        if len(iods) != 1:
            return None
        p1, p2, p3 = self.pages[1], self.pages[2], self.pages[3]
        p4 = self.pages.get(4, {})
        if p4 and p4.get("iod_nav") not in iods:
            p4 = {}
        from gnss_sdr_tpu_torch import constants
        return KeplerEphemeris(
            prn=self.prn, week=self.wn, iode=p1["iod_nav"],
            toe=p3["toe"], toc=p1["toc"],
            af0=p1["af0"], af1=p1["af1"], af2=p1["af2"],
            tgd=p1["bgd_e1e5a"], ura=p1["sisa"],
            m0=p2["m0"], e=p2["e"], sqrt_a=p2["sqrt_a"],
            omega0=p2["omega0"], omega_dot=p2["omega_dot"], idot=p2["idot"],
            i0=p3["i0"], omega=p3["omega"], delta_n=p3["delta_n"],
            cuc=p3["cuc"], cus=p3["cus"], crc=p3["crc"], crs=p3["crs"],
            cic=p4.get("cic", 0.0), cis=p4.get("cis", 0.0),
            gm=constants.GM_EARTH_GAL)
