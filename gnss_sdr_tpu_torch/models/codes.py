"""PRN spreading-code generators for the ported signals: GPS L1 C/A (and
the SBAS L1 codes of the same Gold family), GPS L2 CM, GPS L5 I / Q,
Galileo E1-B / E1-C with the E1-C secondary code CS25, Galileo E5a-I /
E5a-Q with the E5a-Q secondary codes CS100, and BeiDou B1I.

Host-side (numpy): codes are generated once per channel assignment and shipped
to the device as float32 tables; the hot path never regenerates them. The
Galileo memory codes, the L2 CM initial registers, the L5 XB advances and
the B1I phase assignments come from the port's own copies of their ICD
tables (``gnss_sdr_tpu_torch/data/icd_tables_{e1,e5a,l2c,l5,b1i}.json``).
The other signals' generators (and their ICD seed tables) are ported with the
slices that track those signals.

All generators return chips mapped to +/-1.0 float32 with the convention
chip = 1 - 2*bit (bit 0 -> +1.0).
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    out = {}
    for part in ("e1", "e5a", "l2c", "l5", "b1i"):
        out.update(json.loads((_DATA / f"icd_tables_{part}.json").read_text()))
    return out


def _lfsr(n_stages: int, feedback_taps: tuple[int, ...], out_tap: int,
          length: int, init: int | np.ndarray = None) -> np.ndarray:
    """Generic Fibonacci LFSR.

    Registers are numbered 1..n_stages (ICD convention). ``feedback_taps`` are
    XOR'd and fed into stage 1; output is taken from ``out_tap``. ``init`` is a
    bit array (index 0 = stage 1) or None for all-ones.

    Returns the output bit sequence (0/1 uint8) of ``length`` chips.
    """
    reg = np.ones(n_stages, dtype=np.uint8)
    if init is not None:
        reg[:] = init
    out = np.empty(length, dtype=np.uint8)
    taps = [t - 1 for t in feedback_taps]
    for i in range(length):
        out[i] = reg[out_tap - 1]
        fb = 0
        for t in taps:
            fb ^= reg[t]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


def _bits_to_chips(bits: np.ndarray) -> np.ndarray:
    return (1.0 - 2.0 * bits.astype(np.float32)).astype(np.float32)


# ---------------------------------------------------------------------------
# GPS L1 C/A  (IS-GPS-200 sec. 3.3.2.3; Gold codes, G2-delay construction)
# ---------------------------------------------------------------------------

# IS-GPS-200 Table 3-Ia: G2 delay (chips) per PRN 1..37 (33..37 are reserved/ground).
_GPS_CA_G2_DELAY = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251, 252, 254, 255, 256, 257, 258,
    469, 470, 471, 472, 473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862, 863, 950, 947, 786, 948,
)


# DO-229 (SBAS MOPS) Table A-1: G2 delay for SBAS PRN 120..138 — SBAS L1
# uses the same Gold-code family and is tracked on "1C" channels (reference:
# sbas_l1_telemetry_decoder_gs.cc with Gnss_Signal("1C") SBAS satellites)
_SBAS_CA_G2_DELAY = {
    120: 145, 121: 175, 122: 52, 123: 21, 124: 237, 125: 235, 126: 886,
    127: 657, 128: 634, 129: 762, 130: 355, 131: 1012, 132: 176, 133: 603,
    134: 130, 135: 359, 136: 595, 137: 68, 138: 386,
}


@functools.lru_cache(maxsize=64)
def _gps_ca_bits(prn: int) -> np.ndarray:
    if prn in _SBAS_CA_G2_DELAY:
        delay = _SBAS_CA_G2_DELAY[prn]
    elif 1 <= prn <= len(_GPS_CA_G2_DELAY):
        delay = _GPS_CA_G2_DELAY[prn - 1]
    else:
        raise ValueError(f"GPS/SBAS C/A PRN out of range: {prn}")
    g1 = _lfsr(10, (3, 10), 10, 1023)
    g2 = _lfsr(10, (2, 3, 6, 8, 9, 10), 10, 1023)
    return g1 ^ np.roll(g2, delay)


def gps_l1ca_code(prn: int) -> np.ndarray:
    """1023-chip GPS C/A code, +/-1 float32."""
    return _bits_to_chips(_gps_ca_bits(prn))


# ---------------------------------------------------------------------------
# GPS L2 CM  (IS-GPS-200 sec. 3.3.3.2; modular 27-stage shift register)
# ---------------------------------------------------------------------------

_L2C_POLY_MASK = 0o445112474  # feedback mask, IS-GPS-200 Figure 3-12


def _l2c_sequence(init_state: int, length: int) -> np.ndarray:
    x = init_state
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        out[i] = x & 1
        x = (x >> 1) ^ ((x & 1) * _L2C_POLY_MASK)
    return out


def gps_l2cm_code(prn: int) -> np.ndarray:
    """10230-chip GPS L2 CM code, +/-1 float32 (IS-GPS-200 Table 3-Ib)."""
    init = _tables()["gps_l2cm_init_reg"][prn - 1]
    return _bits_to_chips(_l2c_sequence(init, 10230))


# ---------------------------------------------------------------------------
# GPS L5 I/Q  (IS-GPS-705: XA x XB(advance) 13-stage registers)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _l5_xa() -> np.ndarray:
    """XA sequence: 13-stage, taps 9,10,12,13, short-cycled at 8190 chips."""
    n = 10230
    reg = np.ones(13, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        out[i] = reg[12]
        # natural sequence restart: XA resets to all-ones at state 1111111111101
        if np.array_equal(reg, np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1], dtype=np.uint8)):
            reg = np.ones(13, dtype=np.uint8)
            continue
        fb = reg[8] ^ reg[9] ^ reg[11] ^ reg[12]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=4)
def _l5_xb() -> np.ndarray:
    """XB sequence: 13-stage, taps 1,3,4,6,7,8,12,13, free-running."""
    reg = np.ones(13, dtype=np.uint8)
    n = 10230
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        out[i] = reg[12]
        fb = reg[0] ^ reg[2] ^ reg[3] ^ reg[5] ^ reg[6] ^ reg[7] ^ reg[11] ^ reg[12]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


def gps_l5i_code(prn: int) -> np.ndarray:
    """10230-chip GPS L5I code, +/-1 float32 (IS-GPS-705 Table 3-I)."""
    adv = _tables()["gps_l5i_xb_advance"][prn - 1]
    bits = _l5_xa() ^ np.roll(_l5_xb(), -adv)
    return _bits_to_chips(bits)


def gps_l5q_code(prn: int) -> np.ndarray:
    adv = _tables()["gps_l5q_xb_advance"][prn - 1]
    bits = _l5_xa() ^ np.roll(_l5_xb(), -adv)
    return _bits_to_chips(bits)


# ---------------------------------------------------------------------------
# Galileo E1-B / E1-C  (OS SIS ICD Annex C memory codes, hex dumps)
# ---------------------------------------------------------------------------


def _hex_to_bits(h: str, n_bits: int) -> np.ndarray:
    if len(h) % 2:
        h = h + "0"  # ICD hex dumps can end on a nibble boundary
    raw = np.frombuffer(bytes.fromhex(h), dtype=np.uint8)
    bits = np.unpackbits(raw)[:n_bits]
    return bits


def galileo_e1b_code(prn: int) -> np.ndarray:
    """4092-chip E1-B primary code, +/-1 float32, *without* BOC subcarrier."""
    return _bits_to_chips(_hex_to_bits(_tables()["galileo_e1b_primary_hex"][prn - 1], 4092))


def galileo_e1c_code(prn: int) -> np.ndarray:
    return _bits_to_chips(_hex_to_bits(_tables()["galileo_e1c_primary_hex"][prn - 1], 4092))


def galileo_e1c_secondary_code() -> np.ndarray:
    """CS25_1 secondary code on the E1-C pilot (25 chips)."""
    bits = np.array([int(b) for b in _tables()["galileo_e1c_secondary"]], dtype=np.uint8)
    return _bits_to_chips(bits)


# ---------------------------------------------------------------------------
# Galileo E5a I/Q  (OS SIS ICD Annex C memory codes)
# ---------------------------------------------------------------------------


def galileo_e5ai_code(prn: int) -> np.ndarray:
    """10230-chip E5a-I primary code, +/-1 float32."""
    return _bits_to_chips(_hex_to_bits(_tables()["galileo_e5a_i_primary_hex"][prn - 1], 10230))


def galileo_e5aq_code(prn: int) -> np.ndarray:
    return _bits_to_chips(_hex_to_bits(_tables()["galileo_e5a_q_primary_hex"][prn - 1], 10230))


def galileo_e5aq_secondary_code(prn: int) -> np.ndarray:
    """CS100 secondary code on the E5a-Q pilot (100 chips)."""
    table = _tables()["galileo_e5a_q_secondary"]
    bits = np.array([int(b) for b in table[prn - 1]], dtype=np.uint8)
    return _bits_to_chips(bits)


# ---------------------------------------------------------------------------
# BeiDou B1I  (BDS ICD: Gold codes)
# ---------------------------------------------------------------------------


def beidou_b1i_code(prn: int) -> np.ndarray:
    """2046-chip BeiDou B1I code, +/-1 float32.

    G1/G2: 11-stage registers seeded 01010101010; G1 taps (1,7,8,9,10,11),
    G2 taps (1,2,3,4,5,8,9,11); output = G1[11] xor (G2[p1] xor G2[p2]) with
    per-PRN phase assignments from the BDS ICD.
    """
    t = _tables()
    p1 = t["beidou_b1i_phase1"][prn - 1]
    p2 = t["beidou_b1i_phase2"][prn - 1]
    init = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0], dtype=np.uint8)
    n = 2046
    g1 = init.copy()
    g2 = init.copy()
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        out[i] = g1[10] ^ (g2[p1 - 1] ^ g2[p2 - 1])
        fb1 = g1[0] ^ g1[6] ^ g1[7] ^ g1[8] ^ g1[9] ^ g1[10]
        fb2 = g2[0] ^ g2[1] ^ g2[2] ^ g2[3] ^ g2[4] ^ g2[7] ^ g2[8] ^ g2[10]
        g1[1:] = g1[:-1]
        g1[0] = fb1
        g2[1:] = g2[:-1]
        g2[0] = fb2
    return _bits_to_chips(out)


# ---------------------------------------------------------------------------
# Dispatch by signal code + sampling helpers
# ---------------------------------------------------------------------------

_GENERATORS = {
    "1C": lambda prn: gps_l1ca_code(prn),
    "2S": lambda prn: gps_l2cm_code(prn),
    "L5": lambda prn: gps_l5i_code(prn),
    "1B": lambda prn: galileo_e1b_code(prn),
    "5X": lambda prn: galileo_e5ai_code(prn),
    "B1": lambda prn: beidou_b1i_code(prn),
}


def code_chips(signal: str, prn: int) -> np.ndarray:
    """Primary-code chip sequence (+/-1 float32) for a signal/PRN."""
    try:
        gen = _GENERATORS[signal]
    except KeyError:
        raise NotImplementedError(
            f"code generator for signal {signal!r} is not ported yet") from None
    return gen(prn)


# pilot components tracked by the reference's track_pilot option
# (dll_pll_veml_tracking: E1 -> E1-C, E5a -> E5a-Q, L5 -> L5Q)
_PILOT_GENERATORS = {
    "1B": lambda prn: galileo_e1c_code(prn),
    "5X": lambda prn: galileo_e5aq_code(prn),
    "L5": lambda prn: gps_l5q_code(prn),
}


def has_pilot(signal: str) -> bool:
    return signal in _PILOT_GENERATORS


def pilot_code_chips(signal: str, prn: int) -> np.ndarray:
    """Pilot-component chip sequence (+/-1 float32) for a signal/PRN."""
    return _PILOT_GENERATORS[signal](prn)


def pilot_secondary_chips(signal: str, prn: int) -> np.ndarray | None:
    """Pilot secondary code (one chip per primary period), None if absent."""
    if signal == "1B":
        return galileo_e1c_secondary_code()
    if signal == "5X":
        return galileo_e5aq_secondary_code(prn)
    return None


def sample_code(chips: np.ndarray, fs: float, code_rate: float,
                n_samples: int, chip_phase: float = 0.0,
                boc_rate: float = 0.0) -> np.ndarray:
    """Sample a chip sequence at rate ``fs`` (zero-order hold), float32.

    ``boc_rate`` > 0 applies a sine-BOC square subcarrier (e.g. Galileo E1
    BOC(1,1): boc_rate = 1.023e6 -> subcarrier at code_rate).
    """
    n = np.arange(n_samples, dtype=np.float64)
    chip_idx = np.floor(chip_phase + n * (code_rate / fs)).astype(np.int64) % len(chips)
    out = chips[chip_idx]
    if boc_rate > 0.0:
        sub_idx = np.floor(2.0 * (chip_phase * boc_rate / code_rate + n * (boc_rate / fs))).astype(np.int64) % 2
        out = out * (1.0 - 2.0 * sub_idx).astype(np.float32)
    return out.astype(np.float32)
