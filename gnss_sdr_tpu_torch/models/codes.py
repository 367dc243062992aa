"""PRN spreading-code generators for the ported signals: GPS L1 C/A (and
the SBAS L1 codes of the same Gold family) and Galileo E1-B / E1-C with the
E1-C secondary code CS25.

Host-side (numpy): codes are generated once per channel assignment and shipped
to the device as float32 tables; the hot path never regenerates them. The
Galileo E1 memory codes come from the port's own copy of their ICD hex dumps
(``gnss_sdr_tpu_torch/data/icd_tables_e1.json``). The other signals'
generators (and their ICD seed tables) are ported with the slices that track
those signals.

All generators return chips mapped to +/-1.0 float32 with the convention
chip = 1 - 2*bit (bit 0 -> +1.0).
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

_DATA = (pathlib.Path(__file__).resolve().parent.parent / "data"
         / "icd_tables_e1.json")


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    return json.loads(_DATA.read_text())


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
# Dispatch by signal code + sampling helpers
# ---------------------------------------------------------------------------

_GENERATORS = {
    "1C": lambda prn: gps_l1ca_code(prn),
    "1B": lambda prn: galileo_e1b_code(prn),
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
# (dll_pll_veml_tracking: E1 -> E1-C; E5a-Q and L5Q come with those signals)
_PILOT_GENERATORS = {
    "1B": lambda prn: galileo_e1c_code(prn),
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
