"""BeiDou B1I D2 navigation message (GEO satellites, 500 bps; the PyTorch
port's copy of gnss_sdr_tpu/models/nav/beidou_d2.py).

Reference analog: the D2 path of ``beidou_b1i_telemetry_decoder_gs.cc`` and
``beidou_dnav_navigation_message.cc``: GEO satellites (PRN 1..5) transmit at
500 bps with no NH overlay; the ephemeris is split across the ten pages of
subframe 1 (0.6 s each). Word structure (BCH(15,11) x 2, interleaved) is
shared with D1 (models/nav/beidou_d1.py).

Page layout here: the D1 header positions (preamble, FraID=1, SOW) plus a
4-bit page number, then the page's field group packed sequentially into the
remaining information-bit positions (field order and scalings per the ICD;
see beidou_d1._SF* for the shared LSBs).
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import beidou_d1 as d1

PI = 3.1415926535898

# 0-based information-bit positions available for page payload:
# word 1 bits after the page number, then words 2..9 info regions
_PAYLOAD_POS = list(range(46, 52)) + [
    w * 30 + k for w in range(2, 10) for k in range(22)]

# (name, width, signed, lsb) per page number; lsb 0 = raw integer
_PAGES: dict[int, list] = {
    1: [("sat_h1", 1, 0, 0), ("aodc", 5, 0, 0), ("urai", 4, 0, 0),
        ("wn", 13, 0, 0), ("toc", 17, 0, 2.0 ** 3),
        ("tgd1", 10, 1, 0.1e-9)],
    2: [("alpha0", 8, 1, 2.0 ** -30), ("alpha1", 8, 1, 2.0 ** -27),
        ("alpha2", 8, 1, 2.0 ** -24), ("alpha3", 8, 1, 2.0 ** -24),
        ("beta0", 8, 1, 2.0 ** 11), ("beta1", 8, 1, 2.0 ** 14),
        ("beta2", 8, 1, 2.0 ** 16), ("beta3", 8, 1, 2.0 ** 16)],
    3: [("af0", 24, 1, 2.0 ** -33), ("af1", 22, 1, 2.0 ** -50),
        ("af2", 11, 1, 2.0 ** -66), ("aode", 5, 0, 0)],
    4: [("delta_n", 16, 1, PI * 2.0 ** -43), ("cuc", 18, 1, 2.0 ** -31),
        ("m0", 32, 1, PI * 2.0 ** -31)],
    5: [("e", 32, 0, 2.0 ** -33), ("cus", 18, 1, 2.0 ** -31),
        ("crc", 18, 1, 2.0 ** -6), ("crs", 18, 1, 2.0 ** -6)],
    6: [("sqrt_a", 32, 0, 2.0 ** -19), ("toe", 17, 0, 2.0 ** 3)],
    7: [("i0", 32, 1, PI * 2.0 ** -31), ("cic", 18, 1, 2.0 ** -31),
        ("omega_dot", 24, 1, PI * 2.0 ** -43)],
    8: [("cis", 18, 1, 2.0 ** -31), ("idot", 14, 1, PI * 2.0 ** -43),
        ("omega0", 32, 1, PI * 2.0 ** -31)],
    9: [("omega", 32, 1, PI * 2.0 ** -31)],
    10: [],
}


def _eph_value(eph: KeplerEphemeris, iono, name: str) -> float:
    if name.startswith(("alpha", "beta")):
        if iono is None or not iono.valid:
            return 0.0
        arr = iono.alpha if name.startswith("alpha") else iono.beta
        return arr[int(name[-1])]
    table = {"sat_h1": eph.health & 1, "aodc": eph.iodc & 31,
             "urai": eph.ura & 15, "wn": eph.week % 8192,
             "aode": eph.iode & 31, "tgd1": eph.tgd}
    if name in table:
        return table[name]
    return getattr(eph, name)


def encode_page(pnum: int, sow_s: float, eph: KeplerEphemeris,
                iono: IonoParams | None = None) -> np.ndarray:
    """One 300-bit D2 subframe-1 page (transmitted bits, BCH filled)."""
    sf = np.zeros(300, np.uint8)
    sf[0:11] = d1.PREAMBLE
    d1._place(sf, [(16, 3)], 1)                    # FraID = 1
    d1._place(sf, [(19, 8), (31, 12)], int(sow_s) % 604800)
    d1._place(sf, [(43, 4)], pnum)
    payload = []
    for name, width, signed, lsb in _PAGES.get(pnum, []):
        v = _eph_value(eph, iono, name)
        q = int(round(v / lsb)) if lsb else int(v)
        payload.extend(int(b) for b in d1._u2b(q & ((1 << width) - 1), width))
    for i, b in enumerate(payload):
        sf[_PAYLOAD_POS[i]] = b
    out = sf.copy()
    out[0:30] = d1.encode_word(sf[0:26], first=True)
    for w in range(1, 10):
        out[w * 30: (w + 1) * 30] = d1.encode_word(
            sf[w * 30: w * 30 + 22], first=False)
    return out


def decode_page(tx: np.ndarray) -> tuple[int, float, dict] | None:
    """300 hard bits -> (pnum, sow, fields) or None (preamble/BCH fail)."""
    tx = np.asarray(tx, np.uint8)
    if not np.array_equal(tx[0:11], d1.PREAMBLE):
        return None
    sf = np.zeros(300, np.uint8)
    w0 = d1.decode_word(tx[0:30], first=True)
    if w0 is None:
        return None
    sf[0:26] = w0
    for w in range(1, 10):
        wi = d1.decode_word(tx[w * 30: (w + 1) * 30], first=False)
        if wi is None:
            return None
        sf[w * 30: w * 30 + 22] = wi
    if d1._extract(sf, [(16, 3)], False) != 1:
        return None
    sow = float(d1._extract(sf, [(19, 8), (31, 12)], False))
    pnum = d1._extract(sf, [(43, 4)], False)
    fields: dict = {}
    pos = 0
    for name, width, signed, lsb in _PAGES.get(pnum, []):
        bits = np.array([sf[_PAYLOAD_POS[pos + i]] for i in range(width)],
                        np.uint8)
        pos += width
        q = d1._b2s(bits) if signed else d1._b2u(bits)
        fields[name] = q * lsb if lsb else q
    return pnum, sow, fields


def encode_stream(eph: KeplerEphemeris, sow_start: float, n_pages: int,
                  iono: IonoParams | None = None) -> np.ndarray:
    """Subframe-1 pages cycling 1..10, 0.6 s each; returns [n*300] bits.

    The integer SOW field carries the start of the current 6 s page CYCLE
    (page 1); a page with number pnum starts at SOW + 0.6*(pnum-1). This
    keeps the transmitted SOW integer while the decoder recovers page-start
    times at full resolution (see BeidouB1IGeoTelemetry).
    """
    out = []
    for k in range(n_pages):
        pnum = (k % 10) + 1
        cycle_sow = sow_start + 6.0 * (k // 10)
        out.append(encode_page(pnum, cycle_sow, eph, iono))
    return np.concatenate(out)


class D2Assembler:
    """Collects subframe-1 pages into a KeplerEphemeris (+ iono)."""

    NEEDED = (1, 3, 4, 5, 6, 7, 8, 9)

    def __init__(self, prn: int):
        self.prn = prn
        self.pages: dict[int, dict] = {}
        self.iono = IonoParams()

    def push(self, pnum: int, fields: dict) -> None:
        self.pages[pnum] = fields
        if pnum == 2 and "alpha0" in fields:
            self.iono = IonoParams(
                alpha=tuple(fields[f"alpha{i}"] for i in range(4)),
                beta=tuple(fields[f"beta{i}"] for i in range(4)), valid=True)

    def ephemeris(self) -> KeplerEphemeris | None:
        if not all(p in self.pages for p in self.NEEDED):
            return None
        f: dict = {}
        for p in self.NEEDED:
            f.update(self.pages[p])
        return KeplerEphemeris(
            prn=self.prn, week=f["wn"], toc=f["toc"], af0=f["af0"],
            af1=f["af1"], af2=f["af2"], tgd=f["tgd1"],
            iode=f["aode"], iodc=f["aodc"], ura=f["urai"],
            health=f["sat_h1"],
            toe=f["toe"], sqrt_a=f["sqrt_a"], e=f["e"], m0=f["m0"],
            delta_n=f["delta_n"], omega0=f["omega0"],
            omega_dot=f["omega_dot"], omega=f["omega"], i0=f["i0"],
            idot=f["idot"], cuc=f["cuc"], cus=f["cus"], crc=f["crc"],
            crs=f["crs"], cic=f["cic"], cis=f["cis"],
            gm=C.GM_EARTH_BDS)
