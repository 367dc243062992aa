"""GLONASS GNAV navigation message encoder + decoder + PZ-90 orbit model
(the PyTorch port's copy of gnss_sdr_tpu/models/nav/glonass_gnav.py).

Decoder fills the role of the reference's
``glonass_gnav_navigation_message.cc`` + ``glonass_l1_ca_telemetry_decoder_gs``
(meander stripping, time-mark sync, Hamming check); the encoder is the
simulation oracle; the orbit model replaces RTKLIB ``geph2pos`` (RK4
integration of the PZ-90.02 equations of motion with J2).

String format (GLONASS ICD 5.1): 2 s per string = 1.7 s of 85 data bits
(bi-binary/meander at 100 sps) + 0.3 s time mark (30 chips, fixed MLS).
Bit numbering: bit 85 (first transmitted) .. bit 1; bits 1-8 are the KX
Hamming check bits; bit 85 is always 0. Numeric fields are SIGN-MAGNITUDE
(MSB = sign), unlike GPS two's-complement.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib

import numpy as np

# PZ-90.02 constants (GLONASS ICD)
GLO_GM = 398600.44e9           # m^3/s^2
GLO_J2 = 1.0826257e-3
GLO_AE = 6378136.0             # m
GLO_OMEGA = 7.292115e-5        # rad/s

TIME_MARK = np.array([1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1,
                      0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0], np.uint8)

_DATA = (pathlib.Path(__file__).resolve().parent.parent.parent / "data"
         / "icd_tables_glonass.json")


@functools.lru_cache(maxsize=1)
def _crc_tables():
    t = json.loads(_DATA.read_text())
    return {k: np.array(t[f"glonass_gnav_crc_{k}"], np.int64)
            for k in "ijklmnpq"}


@dataclasses.dataclass
class GlonassEphemeris:
    """GLONASS broadcast ephemeris: ECEF state vector at epoch tb."""

    slot: int = 0               # orbital slot number (n)
    freq_slot: int = 0          # FDMA channel k in [-7, 6]
    tb_s: float = 0.0           # epoch within day, Moscow time [s]
    pos_m: tuple = (0.0, 0.0, 0.0)
    vel_m_s: tuple = (0.0, 0.0, 0.0)
    acc_m_s2: tuple = (0.0, 0.0, 0.0)   # lunisolar acceleration
    gamma_n: float = 0.0        # relative frequency offset
    tau_n: float = 0.0          # clock offset [s]
    health: int = 0

    def clock_offset(self, t_sv: float) -> float:
        """SV clock offset (s): dts = -tau_n + gamma_n * (t - tb)."""
        return -self.tau_n + self.gamma_n * (t_sv - self.tb_s)

    def position_velocity(self, t: float):
        """RK4 integration of the PZ-90 equations of motion from tb to t."""
        y = np.array(list(self.pos_m) + list(self.vel_m_s), np.float64)
        acc = np.array(self.acc_m_s2, np.float64)
        dt = t - self.tb_s
        n_steps = max(1, int(abs(dt) / 60.0) + 1)
        h = dt / n_steps
        for _ in range(n_steps):
            k1 = _deriv(y, acc)
            k2 = _deriv(y + 0.5 * h * k1, acc)
            k3 = _deriv(y + 0.5 * h * k2, acc)
            k4 = _deriv(y + h * k3, acc)
            y = y + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        return y[:3].copy(), y[3:].copy()


@dataclasses.dataclass
class GlonassUtc:
    """GNAV string-5 time-scale parameters (reference
    Glonass_Gnav_Utc_Model, glonass_gnav_navigation_message.cc:409-418):
    tau_c relates GLONASS time to UTC(SU); tau_gps to GPS time; N_4 is the
    four-year interval number and day_na the day within it."""

    tau_c: float = 0.0          # GLONASS -> UTC(SU) [s], 2^-31 LSB
    tau_gps: float = 0.0        # GLONASS -> GPS [s], 2^-30 LSB
    n4: int = 0                 # four-year interval since 1996
    day_na: int = 0             # day number within the interval
    l_n: int = 0                # almanac health flag of the transmitter
    valid: bool = False


def _deriv(y: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """PZ-90 ECEF equations of motion with J2 + Earth rotation terms."""
    x, yy, z, vx, vy, vz = y
    r2 = x * x + yy * yy + z * z
    r = np.sqrt(r2)
    gm_r3 = GLO_GM / (r2 * r)
    c = 1.5 * GLO_J2 * GLO_GM * GLO_AE * GLO_AE / (r2 * r2 * r)
    z2_r2 = z * z / r2
    om2 = GLO_OMEGA * GLO_OMEGA
    ax = (-gm_r3 * x - c * x * (1.0 - 5.0 * z2_r2)
          + om2 * x + 2.0 * GLO_OMEGA * vy + acc[0])
    ay = (-gm_r3 * yy - c * yy * (1.0 - 5.0 * z2_r2)
          + om2 * yy - 2.0 * GLO_OMEGA * vx + acc[1])
    az = -gm_r3 * z - c * z * (3.0 - 5.0 * z2_r2) + acc[2]
    return np.array([vx, vy, vz, ax, ay, az])


# ---------------------------------------------------------------------------
# String bit codec (85 bits, ICD numbering: index 0 = bit 85 first on air)
# ---------------------------------------------------------------------------


def _set(bits: np.ndarray, icd_pos: int, width: int, value: int,
         sign_mag: bool = False) -> None:
    """Place value at ICD bit position (LSB at icd_pos, MSB at icd_pos+width-1).

    The array is in transmission order: array index = 85 - icd_bit.
    """
    if sign_mag:
        sign = 1 if value < 0 else 0
        mag = abs(value)
        if mag >= (1 << (width - 1)):
            raise ValueError("magnitude overflow")
        value = (sign << (width - 1)) | mag
    if value < 0 or value >= (1 << width):
        raise ValueError("value overflow")
    for i in range(width):
        bit = (value >> i) & 1
        bits[85 - (icd_pos + i)] = bit


def _get(bits: np.ndarray, icd_pos: int, width: int,
         sign_mag: bool = False) -> int:
    v = 0
    for i in range(width - 1, -1, -1):
        v = (v << 1) | int(bits[85 - (icd_pos + i)])
    if sign_mag:
        mag = v & ((1 << (width - 1)) - 1)
        return -mag if (v >> (width - 1)) else mag
    return v


def hamming_encode(bits: np.ndarray) -> np.ndarray:
    """Fill check bits 1-8 (GLONASS ICD appendix; even-parity Hamming)."""
    t = _crc_tables()
    out = bits.copy()
    # bits 1..7 = parity over their index sets; bit 8 = parity over 9..85 and c1..7
    c = np.zeros(8, np.uint8)
    for i, key in enumerate("ijklmnp"):
        c[i] = np.bitwise_xor.reduce(out[85 - t[key]])
        out[85 - (i + 1)] = c[i]
    # beta = parity of check bits, then c_sum over bits 9..85 + beta
    beta = np.bitwise_xor.reduce(c[:7])
    csum = np.bitwise_xor.reduce(out[85 - t["q"]]) ^ beta
    out[85 - 8] = csum
    return out


def hamming_check(bits: np.ndarray) -> bool:
    t = _crc_tables()
    for i, key in enumerate("ijklmnp"):
        if np.bitwise_xor.reduce(bits[85 - t[key]]) != bits[85 - (i + 1)]:
            return False
    beta = np.bitwise_xor.reduce(bits[np.array([85 - k for k in range(1, 8)])])
    if (np.bitwise_xor.reduce(bits[85 - t["q"]]) ^ beta) != bits[85 - 8]:
        return False
    return True


def encode_string(string_id: int, eph: GlonassEphemeris,
                  tk_s: float | None = None,
                  utc: GlonassUtc | None = None) -> np.ndarray:
    """One 85-bit GNAV string (transmission order, before meander/timemark).

    ``tk_s`` overrides the string-1 frame time (ICD: tk = frame start within
    the day, 30 s resolution); default is the ephemeris epoch tb.
    """
    bits = np.zeros(85, np.uint8)
    _set(bits, 81, 4, string_id)
    scale_p = 2.0 ** -11 * 1e3     # position LSB [m]
    scale_v = 2.0 ** -20 * 1e3
    scale_a = 2.0 ** -30 * 1e3
    if string_id == 1:
        tk = int(eph.tb_s if tk_s is None else tk_s)
        _set(bits, 76, 5, (tk // 3600) % 32)
        _set(bits, 70, 6, (tk % 3600) // 60)
        _set(bits, 69, 1, (tk % 60) // 30)
        _set(bits, 41, 24, int(round(eph.vel_m_s[0] / scale_v)), sign_mag=True)
        _set(bits, 36, 5, int(round(eph.acc_m_s2[0] / scale_a)), sign_mag=True)
        _set(bits, 9, 27, int(round(eph.pos_m[0] / scale_p)), sign_mag=True)
    elif string_id == 2:
        _set(bits, 78, 3, eph.health & 7)
        _set(bits, 70, 7, int(round(eph.tb_s / 900.0)))
        _set(bits, 41, 24, int(round(eph.vel_m_s[1] / scale_v)), sign_mag=True)
        _set(bits, 36, 5, int(round(eph.acc_m_s2[1] / scale_a)), sign_mag=True)
        _set(bits, 9, 27, int(round(eph.pos_m[1] / scale_p)), sign_mag=True)
    elif string_id == 3:
        _set(bits, 69, 11, int(round(eph.gamma_n / 2.0 ** -40)), sign_mag=True)
        _set(bits, 41, 24, int(round(eph.vel_m_s[2] / scale_v)), sign_mag=True)
        _set(bits, 36, 5, int(round(eph.acc_m_s2[2] / scale_a)), sign_mag=True)
        _set(bits, 9, 27, int(round(eph.pos_m[2] / scale_p)), sign_mag=True)
    elif string_id == 4:
        _set(bits, 58, 22, int(round(eph.tau_n / 2.0 ** -30)), sign_mag=True)
        _set(bits, 11, 5, eph.slot & 31)
    elif string_id == 5 and utc is not None:
        # ICD 4.4 table 4.5 (reference GLONASS_L1_L2_CA.h STRING 5 rows:
        # DAY_NUMBER_A {6,11} / TAU_C {17,32} / N_4 {50,5} / TAU_GPS
        # {55,22} / ALM_L_N {77,1}, MSB-based -> LSB bit numbers below)
        _set(bits, 70, 11, utc.day_na & 0x7FF)
        _set(bits, 38, 32, int(round(utc.tau_c / 2.0 ** -31)), sign_mag=True)
        _set(bits, 32, 5, utc.n4 & 31)
        _set(bits, 10, 22, int(round(utc.tau_gps / 2.0 ** -30)),
             sign_mag=True)
        _set(bits, 9, 1, utc.l_n & 1)
    return hamming_encode(bits)


_PI = 3.141592653589793


def encode_almanac_pair(even_sid: int, alm) -> tuple[np.ndarray, np.ndarray]:
    """Encode one GNAV almanac (GlonassAlmanac) into its even/odd string
    pair (ICD 4.5: strings 6/8/10/12/14 carry part 1 for slot n_A, the
    following odd string carries part 2)."""
    b1 = np.zeros(85, np.uint8)
    _set(b1, 81, 4, even_sid)
    _set(b1, 80, 1, 0 if alm.health else 1)          # C_n: 0 = unhealthy
    _set(b1, 73, 5, alm.slot & 31)
    _set(b1, 63, 10, int(round(alm.tau_n / 2.0 ** -18)), sign_mag=True)
    _set(b1, 42, 21, int(round(alm.lambda_n / _PI / 2.0 ** -20)),
         sign_mag=True)
    _set(b1, 24, 18, int(round(alm.delta_i / _PI / 2.0 ** -20)),
         sign_mag=True)
    _set(b1, 9, 15, int(round(alm.ecc / 2.0 ** -20)))
    b2 = np.zeros(85, np.uint8)
    _set(b2, 81, 4, even_sid + 1)
    _set(b2, 65, 16, int(round(alm.omega_n / _PI / 2.0 ** -15)),
         sign_mag=True)
    _set(b2, 44, 21, int(round(alm.t_lambda / 2.0 ** -5)))
    _set(b2, 22, 22, int(round(alm.delta_t / 2.0 ** -9)), sign_mag=True)
    _set(b2, 15, 7, int(round(alm.delta_t_dot / 2.0 ** -14)), sign_mag=True)
    h = alm.freq_slot if alm.freq_slot >= 0 else alm.freq_slot + 32
    _set(b2, 10, 5, h & 31)
    return hamming_encode(b1), hamming_encode(b2)


def decode_string(bits: np.ndarray) -> tuple[int, dict] | None:
    """85 bits (transmission order) -> (string_id, fields) or None."""
    if not hamming_check(bits):
        return None
    sid = _get(bits, 81, 4)
    scale_p = 2.0 ** -11 * 1e3
    scale_v = 2.0 ** -20 * 1e3
    scale_a = 2.0 ** -30 * 1e3
    f: dict = {}
    if sid == 1:
        f["tk_s"] = (_get(bits, 76, 5) * 3600 + _get(bits, 70, 6) * 60
                     + _get(bits, 69, 1) * 30)
        f["vx"] = _get(bits, 41, 24, sign_mag=True) * scale_v
        f["ax"] = _get(bits, 36, 5, sign_mag=True) * scale_a
        f["x"] = _get(bits, 9, 27, sign_mag=True) * scale_p
    elif sid == 2:
        f["health"] = _get(bits, 78, 3)
        f["tb_s"] = _get(bits, 70, 7) * 900.0
        f["vy"] = _get(bits, 41, 24, sign_mag=True) * scale_v
        f["ay"] = _get(bits, 36, 5, sign_mag=True) * scale_a
        f["y"] = _get(bits, 9, 27, sign_mag=True) * scale_p
    elif sid == 3:
        f["gamma_n"] = _get(bits, 69, 11, sign_mag=True) * 2.0 ** -40
        f["vz"] = _get(bits, 41, 24, sign_mag=True) * scale_v
        f["az"] = _get(bits, 36, 5, sign_mag=True) * scale_a
        f["z"] = _get(bits, 9, 27, sign_mag=True) * scale_p
    elif sid == 4:
        f["tau_n"] = _get(bits, 58, 22, sign_mag=True) * 2.0 ** -30
        f["slot"] = _get(bits, 11, 5)
    elif sid == 5:
        f["day_na"] = _get(bits, 70, 11)
        f["tau_c"] = _get(bits, 38, 32, sign_mag=True) * 2.0 ** -31
        f["n4"] = _get(bits, 32, 5)
        f["tau_gps"] = _get(bits, 10, 22, sign_mag=True) * 2.0 ** -30
        f["l_n"] = _get(bits, 9, 1)
    elif sid in (6, 8, 10, 12, 14):
        # almanac part 1 for slot n_A (ICD 4.5)
        f["alm_healthy"] = 1 - _get(bits, 80, 1)
        f["alm_slot"] = _get(bits, 73, 5)
        f["alm_tau"] = _get(bits, 63, 10, sign_mag=True) * 2.0 ** -18
        f["alm_lambda"] = _get(bits, 42, 21, sign_mag=True) * 2.0 ** -20 * _PI
        f["alm_delta_i"] = _get(bits, 24, 18, sign_mag=True) * 2.0 ** -20 * _PI
        f["alm_ecc"] = _get(bits, 9, 15) * 2.0 ** -20
    elif sid in (7, 9, 11, 13, 15):
        # almanac part 2 (pairs with the preceding even string)
        f["alm_omega"] = _get(bits, 65, 16, sign_mag=True) * 2.0 ** -15 * _PI
        f["alm_t_lambda"] = _get(bits, 44, 21) * 2.0 ** -5
        f["alm_delta_t"] = _get(bits, 22, 22, sign_mag=True) * 2.0 ** -9
        f["alm_delta_t_dot"] = _get(bits, 15, 7, sign_mag=True) * 2.0 ** -14
        h = _get(bits, 10, 5)
        f["alm_freq_slot"] = h if h < 16 else h - 32
    return sid, f


def _string_symbols(bits: np.ndarray) -> np.ndarray:
    meander = np.empty(170, np.uint8)
    meander[0::2] = bits
    meander[1::2] = bits ^ 1
    return np.concatenate([meander, TIME_MARK])


def encode_frame_stream(eph: GlonassEphemeris, tk0_s: float,
                        n_frames: int = 2,
                        almanacs: list | None = None,
                        utc: GlonassUtc | None = None) -> np.ndarray:
    """Timing-correct GNAV stream: full 30 s frames of 15 strings, frame f
    starting at day time ``tk0_s + 30 f`` (string 1 carries that tk).
    Strings 6-15 carry up to 5 almanac pairs per frame round-robin from
    ``almanacs`` (GlonassAlmanac list; the real superframe pages 24 slots
    over 5 frames); without almanacs they are valid-Hamming placeholders.
    100 sps symbols."""
    out = []
    alm_idx = 0
    for f in range(n_frames):
        tk = tk0_s + 30.0 * f
        sid = 1
        while sid <= 15:
            if sid <= 4 or (sid == 5 and utc is not None):
                bits = encode_string(sid, eph,
                                     tk_s=(tk if sid == 1 else None),
                                     utc=utc)
                out.append(_string_symbols(bits))
                sid += 1
            elif sid >= 6 and sid % 2 == 0 and almanacs:
                b1, b2 = encode_almanac_pair(
                    sid, almanacs[alm_idx % len(almanacs)])
                alm_idx += 1
                out.append(_string_symbols(b1))
                out.append(_string_symbols(b2))
                sid += 2
            else:
                b = np.zeros(85, np.uint8)
                _set(b, 81, 4, sid)
                bits = hamming_encode(b)
                out.append(_string_symbols(bits))
                sid += 1
    return np.concatenate(out)


def encode_symbol_stream(eph: GlonassEphemeris, n_frames: int = 1) -> np.ndarray:
    """Symbol stream at 100 sps: strings 1..4 cycling, each string =
    85 bits meander-encoded (bit b -> [b, b^1] at 10 ms) + 30-symbol time mark.
    """
    out = []
    for k in range(n_frames * 4):
        sid = k % 4 + 1
        bits = encode_string(sid, eph)
        meander = np.empty(170, np.uint8)
        meander[0::2] = bits
        meander[1::2] = bits ^ 1
        out.append(np.concatenate([meander, TIME_MARK]))
    return np.concatenate(out)


class GnavAssembler:
    def __init__(self, slot: int = 0):
        self.strings: dict[int, dict] = {}
        self.slot = slot
        # constellation almanac from string pairs 6/7..14/15, keyed by slot
        # (reference glonass_gnav_navigation_message almanac branches)
        self.almanacs: dict[int, object] = {}
        self._alm_part1: dict[int, dict] = {}
        self.utc_glo = GlonassUtc()

    def push(self, sid: int, fields: dict) -> None:
        self.strings[sid] = fields
        if sid == 5 and "tau_c" in fields:
            self.utc_glo = GlonassUtc(
                tau_c=fields["tau_c"], tau_gps=fields["tau_gps"],
                n4=fields["n4"], day_na=fields["day_na"],
                l_n=fields["l_n"], valid=True)
        if "alm_slot" in fields:
            self._alm_part1[sid] = fields
        elif "alm_omega" in fields and (sid - 1) in self._alm_part1:
            from gnss_sdr_tpu_torch.models.almanac import GlonassAlmanac
            p1 = self._alm_part1.pop(sid - 1)
            if p1["alm_slot"] == 0:
                return                      # empty almanac slot
            self.almanacs[p1["alm_slot"]] = GlonassAlmanac(
                slot=p1["alm_slot"], health=p1["alm_healthy"],
                tau_n=p1["alm_tau"], lambda_n=p1["alm_lambda"],
                delta_i=p1["alm_delta_i"], ecc=p1["alm_ecc"],
                omega_n=fields["alm_omega"],
                t_lambda=fields["alm_t_lambda"],
                delta_t=fields["alm_delta_t"],
                delta_t_dot=fields["alm_delta_t_dot"],
                freq_slot=fields["alm_freq_slot"])

    def ephemeris(self) -> GlonassEphemeris | None:
        if not all(k in self.strings for k in (1, 2, 3, 4)):
            return None
        s1, s2, s3, s4 = (self.strings[k] for k in (1, 2, 3, 4))
        return GlonassEphemeris(
            slot=s4.get("slot", self.slot),
            tb_s=s2["tb_s"],
            pos_m=(s1["x"], s2["y"], s3["z"]),
            vel_m_s=(s1["vx"], s2["vy"], s3["vz"]),
            acc_m_s2=(s1["ax"], s2["ay"], s3["az"]),
            gamma_n=s3["gamma_n"], tau_n=s4["tau_n"],
            health=s2.get("health", 0),
        )
