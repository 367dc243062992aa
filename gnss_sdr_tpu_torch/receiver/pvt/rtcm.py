"""RTCM 3.x message encoder/decoder + TCP broadcast server.

Port of the GPS part of gnss_sdr_tpu/receiver/pvt/rtcm.py (reference analog:
``src/algorithms/PVT/libs/rtcm.cc`` and ``rtcm_printer.cc``): what the GPS
L1 receiver emits — station reference (1005), GPS broadcast ephemeris (1019)
and GPS MSM1-7 observables (1071-1077) — with encode and decode (decode
doubles as the QA oracle), framing and the TCP server. Messages of
constellations not ported yet (Galileo 1045, GLONASS, BeiDou MSM) raise
``NotImplementedError``.

Framing: 0xD3 preamble, 6 reserved bits, 10-bit length, payload, CRC-24Q
(models/nav/fec.py).
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


def encode_1045(eph: KeplerEphemeris) -> np.ndarray:
    """Galileo F/NAV ephemeris: Galileo is not ported yet."""
    raise NotImplementedError("RTCM 1045 (Galileo ephemeris) is not ported "
                              "yet")


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
MSM1_GPS, MSM2_GPS, MSM3_GPS, MSM6_GPS = 1071, 1072, 1073, 1076

# msm level by message number: {msg: (level, system)}; GPS only (GLONASS,
# Galileo and BeiDou MSM wait for their signals)
MSM_MESSAGES = {1071 + k: (k + 1, "G") for k in range(7)}
_WEEK_MS = 7 * 24 * 3600 * 1000

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


def _msm_kind(msg_num: int) -> tuple[int, str]:
    """(level, system) of an MSM message number; other constellations'
    MSM raise."""
    if msg_num in MSM_MESSAGES:
        return MSM_MESSAGES[msg_num]
    raise NotImplementedError(f"RTCM MSM message {msg_num}: only GPS MSM "
                              f"(1071-1077) is ported")


def encode_msm(msg_num: int, station_id: int, epoch_ms: int,
               obs: list[MsmObservation]) -> np.ndarray:
    """Encode one MSM1..7 message (reference Rtcm::print_MSM_1..7).

    The level comes from ``msg_num`` (MSM_MESSAGES table).
    MSM1-3 carry the rough range modulo 1 ms only (no DF397), so the
    encoded pseudorange is ``pseudorange_m % RANGE_MS``.
    """
    level, _ = _msm_kind(msg_num)
    has_int_ms, pr_l, ph_l, lock_bits, cnr_l, has_rate = _MSM_LAYOUT[level]
    sats = sorted({o.prn for o in obs})
    sigs = sorted({o.signal_id for o in obs})
    cell = {(o.prn, o.signal_id): o for o in obs}

    w = BitWriter()
    w.u(msg_num, 12)
    w.u(station_id, 12)
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
            w.u(0, 4)                   # extended satellite info
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
    level, _ = _msm_kind(msg)
    has_int_ms, pr_l, ph_l, lock_bits, cnr_l, has_rate = _MSM_LAYOUT[level]
    station = r.u(12)
    raw_epoch = r.u(30)
    epoch_ms = raw_epoch
    r.u(1 + 3 + 7 + 2 + 2 + 1 + 3)
    sats = [s for s in range(1, 65) if r.u(1)]
    sigs = [s for s in range(1, 33) if r.u(1)]
    cells = [(p, s) for p in sats for s in sigs]
    present = [c for c in cells if r.u(1)]

    n_ms = ({p: r.u(8) for p in sats} if has_int_ms
            else {p: 0 for p in sats})
    if has_rate:
        for _ in sats:
            r.u(4)                      # extended satellite info
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
            freq_slot=0,
            has_phase=ph_l is not None,
            modulo_1ms=not has_int_ms,
            has_code=pr_l is not None))
    return dict(msg=msg, station_id=station, epoch_ms=epoch_ms,
                raw_epoch=raw_epoch), out


def encode_msm7(msg_num: int, station_id: int, epoch_ms: int,
                obs: list[MsmObservation]) -> np.ndarray:
    """Back-compat wrapper (MSM7 only)."""
    return encode_msm(msg_num, station_id, epoch_ms, obs)


def decode_msm7(bits: np.ndarray) -> tuple[dict, list[MsmObservation]]:
    return decode_msm(bits)


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
