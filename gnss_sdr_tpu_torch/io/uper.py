"""Minimal ASN.1 UNALIGNED PER (UPER, ITU-T X.691) schema codec.

Port of gnss_sdr_tpu/io/uper.py (host code, copied unchanged).

The reference embeds ~81 k lines of asn1c-generated C for the OMA SUPL ULP
and 3GPP RRLP protocols (``src/core/libs/supl/asn-supl``, ``asn-rrlp``).
This module is the TPU-framework substitute: a small declarative schema
engine covering exactly the X.691 encodings those protocols exercise —
constrained/unconstrained integers, extensible SEQUENCE / CHOICE /
ENUMERATED, SEQUENCE OF with size constraints, OCTET/BIT STRING and
known-multiplier character strings — so the protocol modules
(``io/supl.py``) read like the ASN.1 they implement.

Schema objects are composable descriptors with ``encode(w, value)`` /
``decode(r)``; Python values are ints / bools / str / bytes / dicts
(SEQUENCE) / (name, value) tuples (CHOICE) / lists (SEQUENCE OF).

Extension handling: encoding always emits the extension-absent form
(sufficient for the SET side of SUPL); decoding skips unknown extension
additions via their open-type length wrappers, so PDUs from real servers
with release-98/5 extensions still parse.
"""

from __future__ import annotations

import dataclasses


class BitW:
    """MSB-first bit accumulator (no octet alignment — UNALIGNED PER)."""

    def __init__(self):
        self.val = 0
        self.n = 0

    def bits(self, value: int, n: int) -> None:
        if n < 0 or value < 0 or (n < 64 and value >> n):
            raise ValueError(f"uper: {value} does not fit in {n} bits")
        self.val = (self.val << n) | value
        self.n += n

    def tobytes(self) -> bytes:
        pad = (-self.n) % 8
        return ((self.val << pad) | 0).to_bytes((self.n + pad) // 8, "big") \
            if self.n else b""


class BitR:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bits(self, n: int) -> int:
        if self.pos + n > 8 * len(self.data):
            raise ValueError("uper: truncated PDU")
        v = 0
        p = self.pos
        for i in range(n):
            byte = self.data[(p + i) >> 3]
            v = (v << 1) | ((byte >> (7 - ((p + i) & 7))) & 1)
        self.pos += n
        return v


# ------------------------------------------------------------- determinants
def _len_det_enc(w: BitW, n: int) -> None:
    """General length determinant (X.691 §10.9, unaligned): no
    fragmentation support (SUPL/RRLP PDUs are far below 16K)."""
    if n < 128:
        w.bits(n, 8)                     # '0' + 7 bits
    elif n < 16384:
        w.bits(0x8000 | n, 16)           # '10' + 14 bits
    else:
        raise ValueError("uper: length >= 16384 unsupported")


def _len_det_dec(r: BitR) -> int:
    if r.bits(1) == 0:
        return r.bits(7)
    if r.bits(1) == 0:
        return r.bits(14)
    raise ValueError("uper: fragmented length unsupported")


def _nsnn_enc(w: BitW, n: int) -> None:
    """Normally small non-negative whole number (X.691 §10.6)."""
    if n < 64:
        w.bits(n, 7)                     # '0' + 6 bits
    else:
        w.bits(1, 1)
        octets = max(1, (n.bit_length() + 7) // 8)
        _len_det_enc(w, octets)
        w.bits(n, 8 * octets)


def _nsnn_dec(r: BitR) -> int:
    if r.bits(1) == 0:
        return r.bits(6)
    octets = _len_det_dec(r)
    return r.bits(8 * octets)


def _open_enc(w: BitW, payload: bytes) -> None:
    """Open type: general length determinant + whole octets."""
    _len_det_enc(w, max(1, len(payload)))
    for b in (payload or b"\x00"):
        w.bits(b, 8)


def _open_dec(r: BitR) -> bytes:
    n = _len_det_dec(r)
    return bytes(r.bits(8) for _ in range(n))


# ------------------------------------------------------------------ schemas
class INT:
    """INTEGER, constrained (lo..hi) or unconstrained (lo=hi=None).

    Constrained values encode as an offset in ceil(log2(range)) bits
    (X.691 §10.5.7 unaligned); the extensible form adds the escape bit.
    """

    def __init__(self, lo=None, hi=None, ext: bool = False):
        self.lo, self.hi, self.ext = lo, hi, ext
        self.nbits = (hi - lo).bit_length() if lo is not None and hi > lo \
            else 0

    def encode(self, w: BitW, value) -> None:
        value = int(value)
        if self.ext:
            in_root = self.lo <= value <= self.hi
            w.bits(0 if in_root else 1, 1)
            if not in_root:
                self._unconstrained(w, value)
                return
        if self.lo is None:
            self._unconstrained(w, value)
            return
        if not self.lo <= value <= self.hi:
            raise ValueError(f"uper: {value} outside [{self.lo},{self.hi}]")
        w.bits(value - self.lo, self.nbits)

    def decode(self, r: BitR):
        if self.ext and r.bits(1):
            return self._unconstrained_dec(r)
        if self.lo is None:
            return self._unconstrained_dec(r)
        return self.lo + r.bits(self.nbits)

    @staticmethod
    def _unconstrained(w: BitW, value: int) -> None:
        octets = max(1, (value.bit_length() + 8) // 8)   # 2's complement
        _len_det_enc(w, octets)
        w.bits(value & ((1 << (8 * octets)) - 1), 8 * octets)

    @staticmethod
    def _unconstrained_dec(r: BitR) -> int:
        octets = _len_det_dec(r)
        v = r.bits(8 * octets)
        if v >= 1 << (8 * octets - 1):
            v -= 1 << (8 * octets)
        return v


class BOOL:
    def encode(self, w: BitW, value) -> None:
        w.bits(1 if value else 0, 1)

    def decode(self, r: BitR):
        return bool(r.bits(1))


class NULL:
    def encode(self, w: BitW, value) -> None:
        pass

    def decode(self, r: BitR):
        return None


class ENUM:
    """ENUMERATED; values are the name strings. Extension additions decode
    to '_ext_<index>'."""

    def __init__(self, names, ext: bool = False):
        self.names = tuple(names)
        self.ext = ext
        self.idx = INT(0, max(len(self.names) - 1, 0))

    def encode(self, w: BitW, value) -> None:
        if self.ext:
            w.bits(0, 1)
        self.idx.encode(w, self.names.index(value))

    def decode(self, r: BitR):
        if self.ext and r.bits(1):
            return f"_ext_{_nsnn_dec(r)}"
        return self.names[self.idx.decode(r)]


@dataclasses.dataclass
class F:
    """One SEQUENCE field."""

    name: str
    schema: object
    optional: bool = False


class SEQ:
    """SEQUENCE; values are dicts (missing/None keys = absent OPTIONAL).

    Unknown extension additions are skipped on decode (their raw open-type
    bytes are collected under '_ext' for transparency); encode always emits
    the root (extension bit 0).
    """

    def __init__(self, *fields: F, ext: bool = False):
        self.fields = fields
        self.ext = ext

    def encode(self, w: BitW, value) -> None:
        value = value or {}
        if self.ext:
            w.bits(0, 1)
        for f in self.fields:
            if f.optional:
                w.bits(0 if value.get(f.name) is None else 1, 1)
        for f in self.fields:
            v = value.get(f.name)
            if v is None and f.optional:
                continue
            f.schema.encode(w, v)

    def decode(self, r: BitR):
        has_ext = bool(self.ext and r.bits(1))
        present = {f.name: (r.bits(1) == 1) if f.optional else True
                   for f in self.fields}
        out = {}
        for f in self.fields:
            if present[f.name]:
                out[f.name] = f.schema.decode(r)
        if has_ext:
            n = _nsnn_dec(r) + 1            # extension-addition bitmap size
            bitmap = [r.bits(1) for _ in range(n)]
            ext = [_open_dec(r) for b in bitmap if b]
            if ext:
                out["_ext"] = ext
        return out


class CHOICE:
    """CHOICE; values are (alternative_name, value) tuples."""

    def __init__(self, *alts, ext: bool = False):
        self.alts = alts                   # (name, schema) pairs
        self.ext = ext
        self.idx = INT(0, max(len(alts) - 1, 0))

    def encode(self, w: BitW, value) -> None:
        name, v = value
        for i, (n, schema) in enumerate(self.alts):
            if n == name:
                if self.ext:
                    w.bits(0, 1)
                self.idx.encode(w, i)
                schema.encode(w, v)
                return
        raise ValueError(f"uper: unknown CHOICE alternative {name!r}")

    def decode(self, r: BitR):
        if self.ext and r.bits(1):
            i = _nsnn_dec(r)
            return (f"_ext_{i}", _open_dec(r))
        name, schema = self.alts[self.idx.decode(r)]
        return (name, schema.decode(r))


class SEQ_OF:
    def __init__(self, elem, lo: int, hi: int):
        self.elem = elem
        self.len = INT(lo, hi)

    def encode(self, w: BitW, value) -> None:
        self.len.encode(w, len(value))
        for v in value:
            self.elem.encode(w, v)

    def decode(self, r: BitR):
        return [self.elem.decode(r) for _ in range(self.len.decode(r))]


class OCTETS:
    """OCTET STRING; fixed SIZE(n) omits the length, SIZE(lo..hi) uses a
    constrained length, unconstrained uses the general determinant."""

    def __init__(self, lo=None, hi=None, fixed=None):
        self.fixed = fixed
        self.len = INT(lo, hi) if lo is not None else None

    def encode(self, w: BitW, value: bytes) -> None:
        value = bytes(value)
        if self.fixed is not None:
            if len(value) != self.fixed:
                raise ValueError("uper: fixed OCTET STRING size mismatch")
        elif self.len is not None:
            self.len.encode(w, len(value))
        else:
            _len_det_enc(w, len(value))
        for b in value:
            w.bits(b, 8)

    def decode(self, r: BitR) -> bytes:
        n = self.fixed if self.fixed is not None else (
            self.len.decode(r) if self.len is not None else _len_det_dec(r))
        return bytes(r.bits(8) for _ in range(n))


class BITSTR:
    """BIT STRING SIZE(n) (fixed); value is an int, MSB = first bit."""

    def __init__(self, n: int):
        self.n = n

    def encode(self, w: BitW, value: int) -> None:
        w.bits(int(value), self.n)

    def decode(self, r: BitR) -> int:
        return r.bits(self.n)


class CHARSTR:
    """Known-multiplier character string (IA5String / VisibleString),
    optionally with a FROM alphabet constraint (X.691 §27.5, unaligned:
    b = ceil(log2 N) bits per character, index into the sorted alphabet
    when N is not a power-of-two canonical set)."""

    def __init__(self, lo=None, hi=None, alphabet: str | None = None,
                 canonical_bits: int = 7):
        self.len = INT(lo, hi) if lo is not None else None
        if alphabet is not None:
            chars = sorted(set(alphabet))
            self.bits_per = max(1, (len(chars) - 1).bit_length())
            if self.bits_per >= canonical_bits:
                self.alphabet = None       # canonical encoding is smaller
                self.bits_per = canonical_bits
            else:
                self.alphabet = {c: i for i, c in enumerate(chars)}
                self.rev = chars
        else:
            self.alphabet = None
            self.bits_per = canonical_bits

    def encode(self, w: BitW, value: str) -> None:
        if self.len is not None:
            self.len.encode(w, len(value))
        else:
            _len_det_enc(w, len(value))
        for c in value:
            w.bits(self.alphabet[c] if self.alphabet is not None else ord(c),
                   self.bits_per)

    def decode(self, r: BitR) -> str:
        n = self.len.decode(r) if self.len is not None else _len_det_dec(r)
        return "".join(
            (self.rev[r.bits(self.bits_per)] if self.alphabet is not None
             else chr(r.bits(self.bits_per))) for _ in range(n))


def encode(schema, value) -> bytes:
    w = BitW()
    schema.encode(w, value)
    return w.tobytes()


def decode(schema, data: bytes):
    return schema.decode(BitR(data))
