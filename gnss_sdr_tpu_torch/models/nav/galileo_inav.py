"""Galileo E1-B I/NAV navigation message encoder + decoder (the port's copy
of gnss_sdr_tpu/models/nav/galileo_inav.py).

Decoder fills the role of the reference's
``galileo_navigation_message.cc`` + ``galileo_telemetry_decoder_gs.cc``
(deinterleave 30x8, K=7 r=1/2 Viterbi with inverted G2, CRC-24Q, word
assembly); the encoder is the simulation/test oracle.

Page structure (OS SIS ICD 4.3): a nominal page = even part (1 s, 250
symbols) + odd part (1 s, 250 symbols). Each part = 10-symbol sync pattern
0101100000 + 240 coded symbols = Viterbi(114 data bits + 6 tail),
block-interleaved 30 columns x 8 rows.

  even part bits: [even/odd=0, page_type, word[0:112]]                 (114)
  odd  part bits: [even/odd=1, page_type, word[112:128], osnma(40),
                   sar(22), spare(2), crc(24), ssp(8)]                 (114)
  CRC-24Q over the leading 196 bits (everything before the CRC field).

Word types (128 bits each, type in bits 0..5): 1-4 ephemeris+clock,
5 iono/BGD/health + GST(WN, TOW), 6 UTC. Field positions follow the ICD
tables (cross-checked against the reference's Galileo_E1.h constants).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import fec

SYNC = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.uint8)
PI = 3.1415926535898
PAGE_PART_SYMBOLS = 250


def _u2b(value: int, n: int) -> np.ndarray:
    if value < 0 or value >= (1 << n):
        raise ValueError(f"{value} out of range u{n}")
    return np.array([(value >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _s2b(value: int, n: int) -> np.ndarray:
    if value < -(1 << (n - 1)) or value >= (1 << (n - 1)):
        raise ValueError(f"{value} out of range s{n}")
    return _u2b(value & ((1 << n) - 1), n)


def _b2u(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _b2s(bits) -> int:
    v = _b2u(bits)
    if v >= (1 << (len(bits) - 1)):
        v -= 1 << len(bits)
    return v


def _q(value: float, scale: float, n: int, signed=True) -> np.ndarray:
    q = int(round(value / scale))
    return _s2b(q, n) if signed else _u2b(q, n)


# ---------------------------------------------------------------------------
# Word encode/decode (128-bit words; positions per ICD: type=bits 0..5)
# ---------------------------------------------------------------------------


def encode_word(wtype: int, eph: KeplerEphemeris, *, wn: int = 0,
                tow: float = 0.0) -> np.ndarray:
    w = np.zeros(128, np.uint8)
    w[0:6] = _u2b(wtype, 6)
    sc = PI
    if wtype == 1:
        w[6:16] = _u2b(eph.iode & 0x3FF, 10)
        w[16:30] = _u2b(int(eph.toe / 60.0), 14)
        w[30:62] = _q(eph.m0 / sc, 2.0 ** -31, 32)
        w[62:94] = _q(eph.e, 2.0 ** -33, 32, signed=False)
        w[94:126] = _q(eph.sqrt_a, 2.0 ** -19, 32, signed=False)
    elif wtype == 2:
        w[6:16] = _u2b(eph.iode & 0x3FF, 10)
        w[16:48] = _q(eph.omega0 / sc, 2.0 ** -31, 32)
        w[48:80] = _q(eph.i0 / sc, 2.0 ** -31, 32)
        w[80:112] = _q(eph.omega / sc, 2.0 ** -31, 32)
        w[112:126] = _q(eph.idot / sc, 2.0 ** -43, 14)
    elif wtype == 3:
        w[6:16] = _u2b(eph.iode & 0x3FF, 10)
        w[16:40] = _q(eph.omega_dot / sc, 2.0 ** -43, 24)
        w[40:56] = _q(eph.delta_n / sc, 2.0 ** -43, 16)
        w[56:72] = _q(eph.cuc, 2.0 ** -29, 16)
        w[72:88] = _q(eph.cus, 2.0 ** -29, 16)
        w[88:104] = _q(eph.crc, 2.0 ** -5, 16)
        w[104:120] = _q(eph.crs, 2.0 ** -5, 16)
        w[120:128] = _u2b(eph.ura & 0xFF, 8)       # SISA index
    elif wtype == 4:
        w[6:16] = _u2b(eph.iode & 0x3FF, 10)
        w[16:22] = _u2b(eph.prn & 0x3F, 6)
        w[22:38] = _q(eph.cic, 2.0 ** -29, 16)
        w[38:54] = _q(eph.cis, 2.0 ** -29, 16)
        w[54:68] = _u2b(int(eph.toc / 60.0), 14)
        w[68:99] = _q(eph.af0, 2.0 ** -34, 31)
        w[99:120] = _q(eph.af1, 2.0 ** -46, 21)
        w[120:126] = _q(eph.af2, 2.0 ** -59, 6)
    elif wtype == 5:
        # iono left zero; BGD = tgd (E1/E5a); GST
        w[47:57] = _q(eph.tgd, 2.0 ** -32, 10)
        w[73:85] = _u2b(wn % 4096, 12)
        w[85:105] = _u2b(int(tow) % 604800, 20)
    elif wtype == 6:
        w[105:125] = _u2b(int(tow) % 604800, 20)
    return w


def encode_almanac_words(alms, *, wn_a: int, t0a: float, ioda: int = 1,
                         ggto: tuple | None = None) -> list[np.ndarray]:
    """Encode up to 3 almanacs into I/NAV words 7-10 (ICD 4.3.5 tables 75-78;
    field positions cross-checked against the reference's Galileo_E1.h
    *_7..10_BIT constants). ``ggto`` = (a0g, a1g, t0g, wn0g) GST-GPS
    conversion parameters carried in word 10 (zeros when None)."""
    from gnss_sdr_tpu_torch.models.almanac import GalileoAlmanac
    alms = list(alms) + [None] * (3 - len(alms))
    if len(alms) > 3:
        raise ValueError("words 7-10 carry at most 3 almanacs per IODa")
    sc = PI

    def part1(w, p, a: "GalileoAlmanac"):
        """svid + delta_a/e/omega/delta_i starting at bit p (w7/w8/w9)."""
        w[p:p + 6] = _u2b(a.svid & 0x3F, 6)
        w[p + 6:p + 19] = _q(a.delta_sqrt_a, 2.0 ** -9, 13)
        w[p + 19:p + 30] = _q(a.e, 2.0 ** -16, 11, signed=False)
        w[p + 30:p + 46] = _q(a.omega / sc, 2.0 ** -15, 16)
        w[p + 46:p + 57] = _q(a.delta_i / sc, 2.0 ** -14, 11)

    w7 = np.zeros(128, np.uint8)
    w7[0:6] = _u2b(7, 6)
    w7[6:10] = _u2b(ioda & 0xF, 4)
    w7[10:12] = _u2b(wn_a & 0x3, 2)
    w7[12:22] = _u2b(int(t0a / 600.0) & 0x3FF, 10)
    a1 = alms[0]
    if a1 is not None:
        part1(w7, 22, a1)
        w7[79:95] = _q(a1.omega0 / sc, 2.0 ** -15, 16)
        w7[95:106] = _q(a1.omega_dot / sc, 2.0 ** -33, 11)
        w7[106:122] = _q(a1.m0 / sc, 2.0 ** -15, 16)

    w8 = np.zeros(128, np.uint8)
    w8[0:6] = _u2b(8, 6)
    w8[6:10] = _u2b(ioda & 0xF, 4)
    if a1 is not None:
        w8[10:26] = _q(a1.af0, 2.0 ** -19, 16)
        w8[26:39] = _q(a1.af1, 2.0 ** -38, 13)
        w8[39:41] = _u2b(a1.e5b_hs & 0x3, 2)
        w8[41:43] = _u2b(a1.e1b_hs & 0x3, 2)
    a2 = alms[1]
    if a2 is not None:
        part1(w8, 43, a2)
        w8[100:116] = _q(a2.omega0 / sc, 2.0 ** -15, 16)
        w8[116:127] = _q(a2.omega_dot / sc, 2.0 ** -33, 11)

    w9 = np.zeros(128, np.uint8)
    w9[0:6] = _u2b(9, 6)
    w9[6:10] = _u2b(ioda & 0xF, 4)
    w9[10:12] = _u2b(wn_a & 0x3, 2)
    w9[12:22] = _u2b(int(t0a / 600.0) & 0x3FF, 10)
    if a2 is not None:
        w9[22:38] = _q(a2.m0 / sc, 2.0 ** -15, 16)
        w9[38:54] = _q(a2.af0, 2.0 ** -19, 16)
        w9[54:67] = _q(a2.af1, 2.0 ** -38, 13)
        w9[67:69] = _u2b(a2.e5b_hs & 0x3, 2)
        w9[69:71] = _u2b(a2.e1b_hs & 0x3, 2)
    a3 = alms[2]
    if a3 is not None:
        part1(w9, 71, a3)

    w10 = np.zeros(128, np.uint8)
    w10[0:6] = _u2b(10, 6)
    w10[6:10] = _u2b(ioda & 0xF, 4)
    if a3 is not None:
        w10[10:26] = _q(a3.omega0 / sc, 2.0 ** -15, 16)
        w10[26:37] = _q(a3.omega_dot / sc, 2.0 ** -33, 11)
        w10[37:53] = _q(a3.m0 / sc, 2.0 ** -15, 16)
        w10[53:69] = _q(a3.af0, 2.0 ** -19, 16)
        w10[69:82] = _q(a3.af1, 2.0 ** -38, 13)
        w10[82:84] = _u2b(a3.e5b_hs & 0x3, 2)
        w10[84:86] = _u2b(a3.e1b_hs & 0x3, 2)
    if ggto is not None:
        a0g, a1g, t0g, wn0g = ggto
        w10[86:102] = _q(a0g, 2.0 ** -35, 16)
        w10[102:114] = _q(a1g, 2.0 ** -51, 12)
        w10[114:122] = _u2b(int(t0g / 3600.0) & 0xFF, 8)
        w10[122:128] = _u2b(wn0g & 0x3F, 6)
    return [w7, w8, w9, w10]


def decode_word(w: np.ndarray) -> tuple[int, dict]:
    wtype = _b2u(w[0:6])
    sc = PI
    f: dict = {}
    if wtype == 1:
        f["iod_nav"] = _b2u(w[6:16])
        f["toe"] = _b2u(w[16:30]) * 60.0
        f["m0"] = _b2s(w[30:62]) * 2.0 ** -31 * sc
        f["e"] = _b2u(w[62:94]) * 2.0 ** -33
        f["sqrt_a"] = _b2u(w[94:126]) * 2.0 ** -19
    elif wtype == 2:
        f["iod_nav"] = _b2u(w[6:16])
        f["omega0"] = _b2s(w[16:48]) * 2.0 ** -31 * sc
        f["i0"] = _b2s(w[48:80]) * 2.0 ** -31 * sc
        f["omega"] = _b2s(w[80:112]) * 2.0 ** -31 * sc
        f["idot"] = _b2s(w[112:126]) * 2.0 ** -43 * sc
    elif wtype == 3:
        f["iod_nav"] = _b2u(w[6:16])
        f["omega_dot"] = _b2s(w[16:40]) * 2.0 ** -43 * sc
        f["delta_n"] = _b2s(w[40:56]) * 2.0 ** -43 * sc
        f["cuc"] = _b2s(w[56:72]) * 2.0 ** -29
        f["cus"] = _b2s(w[72:88]) * 2.0 ** -29
        f["crc"] = _b2s(w[88:104]) * 2.0 ** -5
        f["crs"] = _b2s(w[104:120]) * 2.0 ** -5
        f["sisa"] = _b2u(w[120:128])
    elif wtype == 4:
        f["iod_nav"] = _b2u(w[6:16])
        f["svid"] = _b2u(w[16:22])
        f["cic"] = _b2s(w[22:38]) * 2.0 ** -29
        f["cis"] = _b2s(w[38:54]) * 2.0 ** -29
        f["toc"] = _b2u(w[54:68]) * 60.0
        f["af0"] = _b2s(w[68:99]) * 2.0 ** -34
        f["af1"] = _b2s(w[99:120]) * 2.0 ** -46
        f["af2"] = _b2s(w[120:126]) * 2.0 ** -59
    elif wtype == 5:
        f["bgd_e1e5a"] = _b2s(w[47:57]) * 2.0 ** -32
        f["wn"] = _b2u(w[73:85])
        f["tow"] = float(_b2u(w[85:105]))
    elif wtype == 6:
        f["tow"] = float(_b2u(w[105:125]))
    elif wtype in (7, 8, 9, 10):
        f["ioda"] = _b2u(w[6:10])

        def alm_part1(p):
            return {
                "svid": _b2u(w[p:p + 6]),
                "delta_sqrt_a": _b2s(w[p + 6:p + 19]) * 2.0 ** -9,
                "e": _b2u(w[p + 19:p + 30]) * 2.0 ** -16,
                "omega": _b2s(w[p + 30:p + 46]) * 2.0 ** -15 * sc,
                "delta_i": _b2s(w[p + 46:p + 57]) * 2.0 ** -14 * sc,
            }

        if wtype in (7, 9):
            f["wn_a"] = _b2u(w[10:12])
            f["t0a"] = _b2u(w[12:22]) * 600.0
        if wtype == 7:
            f.update(alm_part1(22))
            f["omega0"] = _b2s(w[79:95]) * 2.0 ** -15 * sc
            f["omega_dot"] = _b2s(w[95:106]) * 2.0 ** -33 * sc
            f["m0"] = _b2s(w[106:122]) * 2.0 ** -15 * sc
        elif wtype == 8:
            f["af0"] = _b2s(w[10:26]) * 2.0 ** -19
            f["af1"] = _b2s(w[26:39]) * 2.0 ** -38
            f["e5b_hs"] = _b2u(w[39:41])
            f["e1b_hs"] = _b2u(w[41:43])
            nxt = alm_part1(43)
            nxt["omega0"] = _b2s(w[100:116]) * 2.0 ** -15 * sc
            nxt["omega_dot"] = _b2s(w[116:127]) * 2.0 ** -33 * sc
            f["next"] = nxt
        elif wtype == 9:
            f["m0"] = _b2s(w[22:38]) * 2.0 ** -15 * sc
            f["af0"] = _b2s(w[38:54]) * 2.0 ** -19
            f["af1"] = _b2s(w[54:67]) * 2.0 ** -38
            f["e5b_hs"] = _b2u(w[67:69])
            f["e1b_hs"] = _b2u(w[69:71])
            f["next"] = alm_part1(71)
        elif wtype == 10:
            f["omega0"] = _b2s(w[10:26]) * 2.0 ** -15 * sc
            f["omega_dot"] = _b2s(w[26:37]) * 2.0 ** -33 * sc
            f["m0"] = _b2s(w[37:53]) * 2.0 ** -15 * sc
            f["af0"] = _b2s(w[53:69]) * 2.0 ** -19
            f["af1"] = _b2s(w[69:82]) * 2.0 ** -38
            f["e5b_hs"] = _b2u(w[82:84])
            f["e1b_hs"] = _b2u(w[84:86])
            f["a0g"] = _b2s(w[86:102]) * 2.0 ** -35
            f["a1g"] = _b2s(w[102:114]) * 2.0 ** -51
            f["t0g"] = _b2u(w[114:122]) * 3600.0
            f["wn0g"] = _b2u(w[122:128])
    return wtype, f


# ---------------------------------------------------------------------------
# Page (even+odd) <-> 500 symbols
# ---------------------------------------------------------------------------


def encode_page(word: np.ndarray) -> np.ndarray:
    """One nominal page (even+odd parts) -> 500 symbols (0/1)."""
    even = np.concatenate([[0, 0], word[:112]]).astype(np.uint8)
    odd = np.concatenate([[1, 0], word[112:128],
                          np.zeros(40 + 22 + 2, np.uint8)]).astype(np.uint8)
    crc = fec.crc24q_bits(np.concatenate([even, odd]))
    odd = np.concatenate([odd, _u2b(crc, 24), np.zeros(8, np.uint8)])
    assert len(even) == 114 and len(odd) == 114

    out = []
    for part in (even, odd):
        sym = fec.conv_encode(part, invert_g2=True)          # 240 symbols
        sym = fec.block_interleave(sym, 30, 8)
        out.append(np.concatenate([SYNC, sym]))
    return np.concatenate(out)


def decode_page(symbols: np.ndarray) -> tuple[int, dict] | None:
    """500 hard/soft symbols (+1 = bit 1) -> (word_type, fields) or None.

    Expects symbols aligned at the even-part sync. Checks both sync patterns
    and the CRC.
    """
    s = np.asarray(symbols, np.float64)
    parts = []
    for p in range(2):
        seg = s[p * 250: (p + 1) * 250]
        sync_pm = 1.0 - 2.0 * SYNC.astype(np.float64)
        corr = float(np.dot(np.sign(seg[:10]), -sync_pm))  # +amp == bit 1
        if abs(corr) < 10:
            return None
        pol = 1.0 if corr > 0 else -1.0
        desym = fec.block_deinterleave(pol * seg[10:], 30, 8)
        bits = fec.viterbi_decode(desym, 114, invert_g2=True)
        parts.append(bits)
    even, odd = parts
    if even[0] != 0 or odd[0] != 1:
        return None
    msg = np.concatenate([even, odd[:82]])
    crc = fec.crc24q_bits(msg)
    if crc != _b2u(odd[82:106]):
        return None
    word = np.concatenate([even[2:114], odd[2:18]])
    return decode_word(word)


# ---------------------------------------------------------------------------
# Stream assembly (encoder side, for the signal generator)
# ---------------------------------------------------------------------------


def encode_stream(eph: KeplerEphemeris, tow_start_s: float,
                  n_pages: int, almanacs=None,
                  ggto: tuple | None = None) -> np.ndarray:
    """Continuous E1-B symbol stream: pages cycle word types 1,2,3,4,5
    (plus 7,8,9,10 almanac batches when ``almanacs`` is given, mirroring
    the nominal I/NAV sub-frame layout's almanac slots).

    Page k starts at GST tow_start_s + 2k; word 5 carries the TOW of its own
    page start (the receiver anchors time there). Almanacs rotate in
    batches of 3 SVIDs per 4-word set, one IODa per batch.
    """
    wtypes = (1, 2, 3, 4, 5) if not almanacs else (1, 2, 3, 4, 5,
                                                   7, 8, 9, 10, 5)
    alm_batches = []
    if almanacs:
        alms = list(almanacs)
        for b in range(0, len(alms), 3):
            batch = alms[b:b + 3]
            alm_batches.append(encode_almanac_words(
                batch, wn_a=batch[0].wna, t0a=batch[0].toa,
                ioda=(batch[0].ioda + b // 3) & 0xF, ggto=ggto))
    out = []
    wn = eph.week
    n_cycles = 0
    for k in range(n_pages):
        wt = wtypes[k % len(wtypes)]
        if k and k % len(wtypes) == 0:
            n_cycles += 1
        tow = tow_start_s + 2.0 * k
        if wt in (7, 8, 9, 10):
            batch = alm_batches[n_cycles % len(alm_batches)]
            word = batch[wt - 7]
        else:
            word = encode_word(wt, eph, wn=wn, tow=tow)
        out.append(encode_page(word))
    return np.concatenate(out)


@dataclasses.dataclass
class InavPage:
    wtype: int
    fields: dict
    first_symbol_index: int     # symbol index in the channel's stream


class InavAssembler:
    """Collects decoded words into a KeplerEphemeris (+ TOW anchoring)."""

    def __init__(self, prn: int):
        self.prn = prn
        self.words: dict[int, dict] = {}
        self.tow_anchor: tuple[float, int] | None = None  # (tow_s, symbol_idx)
        # constellation almanac from words 7-10 (reference
        # galileo_navigation_message.cc have_new_almanac/get_almanac),
        # keyed by the almanac's own SVID — harvested by the receiver
        self.almanacs: dict[int, object] = {}
        self.ggto: tuple | None = None  # (a0g, a1g, t0g, wn0g) GST-GPS

    def push(self, page: InavPage) -> None:
        self.words[page.wtype] = page.fields
        if page.wtype == 5 and "tow" in page.fields:
            self.tow_anchor = (page.fields["tow"], page.first_symbol_index)
        if page.wtype in (7, 8, 9, 10):
            self._assemble_almanacs()

    def _assemble_almanacs(self) -> None:
        """Merge words 7-10 of one IODa set into up to three GalileoAlmanac
        records (word pairing per ICD 4.3.5: SVID1=7+8, SVID2=8+9,
        SVID3=9+10; svid 0 = empty slot)."""
        need = (7, 8, 9, 10)
        if not all(k in self.words for k in need):
            return
        w7, w8, w9, w10 = (self.words[k] for k in need)
        if len({w["ioda"] for w in (w7, w8, w9, w10)}) != 1:
            return
        from gnss_sdr_tpu_torch.models.almanac import GalileoAlmanac
        ioda, wn_a, t0a = w7["ioda"], w7["wn_a"], w7["t0a"]
        common = dict(ioda=ioda, wna=wn_a, toa=t0a)
        sets = [
            ({k: w7[k] for k in ("svid", "delta_sqrt_a", "e", "omega",
                                 "delta_i", "omega0", "omega_dot", "m0")},
             {k: w8[k] for k in ("af0", "af1", "e5b_hs", "e1b_hs")}),
            (w8["next"],
             {k: w9[k] for k in ("m0", "af0", "af1", "e5b_hs", "e1b_hs")}),
            (w9["next"],
             {k: w10[k] for k in ("omega0", "omega_dot", "m0", "af0", "af1",
                                  "e5b_hs", "e1b_hs")}),
        ]
        for part1, part2 in sets:
            svid = part1["svid"]
            if svid == 0:
                continue
            fields = {**part1, **part2, **common}
            self.almanacs[svid] = GalileoAlmanac(
                svid=svid,
                delta_sqrt_a=fields["delta_sqrt_a"], e=fields["e"],
                delta_i=fields["delta_i"], omega0=fields["omega0"],
                omega_dot=fields["omega_dot"], omega=fields["omega"],
                m0=fields["m0"], af0=fields["af0"], af1=fields["af1"],
                ioda=ioda, wna=wn_a, toa=t0a,
                e5b_hs=fields["e5b_hs"], e1b_hs=fields["e1b_hs"])
        if "a0g" in w10:
            self.ggto = (w10["a0g"], w10["a1g"], w10["t0g"], w10["wn0g"])

    def ephemeris(self) -> KeplerEphemeris | None:
        need = (1, 2, 3, 4)
        if not all(k in self.words for k in need):
            return None
        iods = {self.words[k]["iod_nav"] for k in need}
        if len(iods) != 1:
            return None
        w1, w2, w3, w4 = (self.words[k] for k in need)
        w5 = self.words.get(5, {})
        return KeplerEphemeris(
            prn=self.prn, week=int(w5.get("wn", 0)),
            toe=w1["toe"], m0=w1["m0"], e=w1["e"], sqrt_a=w1["sqrt_a"],
            omega0=w2["omega0"], i0=w2["i0"], omega=w2["omega"],
            idot=w2["idot"],
            omega_dot=w3["omega_dot"], delta_n=w3["delta_n"],
            cuc=w3["cuc"], cus=w3["cus"], crc=w3["crc"], crs=w3["crs"],
            cic=w4["cic"], cis=w4["cis"], toc=w4["toc"],
            af0=w4["af0"], af1=w4["af1"], af2=w4["af2"],
            tgd=w5.get("bgd_e1e5a", 0.0),
            iode=w1["iod_nav"], iodc=w1["iod_nav"],
            gm=C.GM_EARTH_GAL,
        )
