"""Physical and per-signal constants of the GNSS receiver (the PyTorch port's
copy of gnss_sdr_tpu/constants.py).

Mirrors the role of GNSS-SDR's constants headers
(``src/core/system_parameters/GPS_L1_CA.h``, ``Galileo_E1.h``, ``GPS_L2C.h``,
``GPS_L5.h``, ``Glonass_L1_CA.h``, ``Beidou_B1I.h``) but is a
fresh, data-driven design: one frozen ``SignalSpec`` record per signal keyed by
the same two-character signal codes the reference uses ("1C", "2S", "L5", "1B",
"5X", "1G", "2G", "B1", "B3").
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Universal physical constants (WGS-84 / IS-GPS-200)
# ---------------------------------------------------------------------------
SPEED_OF_LIGHT_M_S = 299_792_458.0
GM_EARTH = 3.986005e14          # WGS-84 gravitational constant [m^3/s^2] (GPS value)
GM_EARTH_GAL = 3.986004418e14   # Galileo ICD value
GM_EARTH_BDS = 3.986004418e14   # BeiDou ICD value
OMEGA_EARTH_DOT = 7.2921151467e-5      # Earth rotation rate [rad/s]
F_REL = -4.442807633e-10        # relativistic clock constant [s/m^0.5]
PI_GPS = 3.1415926535898        # pi as fixed by IS-GPS-200

WGS84_A = 6378137.0             # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563   # flattening
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)

SECONDS_PER_WEEK = 604800.0
HALF_WEEK = 302400.0

# ---------------------------------------------------------------------------
# Per-signal specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """Static description of one GNSS signal component."""

    system: str                 # 'G' GPS, 'E' Galileo, 'R' GLONASS, 'C' BeiDou, 'S' SBAS
    signal: str                 # two-char code, reference-compatible ("1C", ...)
    name: str
    carrier_freq_hz: float      # nominal carrier (FDMA base freq for GLONASS)
    code_rate_cps: float        # chipping rate [chips/s]
    code_length_chips: int      # primary code length
    code_period_s: float        # primary code period
    bit_period_ms: int          # nav data bit (or symbol) period in ms
    prn_max: int
    # FDMA channel spacing (GLONASS); 0 for CDMA signals
    fdma_step_hz: float = 0.0
    # sub-carrier (BOC) rate, 0 for BPSK
    subcarrier_rate_hz: float = 0.0
    # secondary code (pilot/overlay), None if absent
    secondary_code: str | None = None

    @property
    def code_period_ms(self) -> float:
        return self.code_period_s * 1e3


GPS_L1_CA = SignalSpec(
    system="G", signal="1C", name="GPS L1 C/A",
    carrier_freq_hz=1_575_420_000.0, code_rate_cps=1.023e6,
    code_length_chips=1023, code_period_s=1e-3, bit_period_ms=20, prn_max=32,
)

GPS_L2_CM = SignalSpec(
    system="G", signal="2S", name="GPS L2 CM",
    carrier_freq_hz=1_227_600_000.0, code_rate_cps=0.5115e6,
    code_length_chips=10230, code_period_s=20e-3, bit_period_ms=20, prn_max=32,
)

GPS_L5_I = SignalSpec(
    system="G", signal="L5", name="GPS L5I",
    carrier_freq_hz=1_176_450_000.0, code_rate_cps=10.23e6,
    code_length_chips=10230, code_period_s=1e-3, bit_period_ms=10, prn_max=32,
    secondary_code="0000110101",  # 10-bit Neuman-Hofman on L5I
)

GALILEO_E1_B = SignalSpec(
    system="E", signal="1B", name="Galileo E1B",
    carrier_freq_hz=1_575_420_000.0, code_rate_cps=1.023e6,
    code_length_chips=4092, code_period_s=4e-3, bit_period_ms=4, prn_max=50,
    subcarrier_rate_hz=1.023e6,  # CBOC(6,1,1/11) dominant BOC(1,1) component
)

GALILEO_E5A_I = SignalSpec(
    system="E", signal="5X", name="Galileo E5a-I",
    carrier_freq_hz=1_176_450_000.0, code_rate_cps=10.23e6,
    code_length_chips=10230, code_period_s=1e-3, bit_period_ms=20, prn_max=50,
    secondary_code="10000100001011101001",  # CS20 (0x842E9) on E5a-I data
)

GLONASS_L1_CA = SignalSpec(
    system="R", signal="1G", name="GLONASS L1 C/A",
    carrier_freq_hz=1_602_000_000.0, code_rate_cps=0.511e6,
    code_length_chips=511, code_period_s=1e-3, bit_period_ms=10, prn_max=24,
    fdma_step_hz=562_500.0,
)

GLONASS_L2_CA = SignalSpec(
    system="R", signal="2G", name="GLONASS L2 C/A",
    carrier_freq_hz=1_246_000_000.0, code_rate_cps=0.511e6,
    code_length_chips=511, code_period_s=1e-3, bit_period_ms=10, prn_max=24,
    fdma_step_hz=437_500.0,
)

BEIDOU_B1I = SignalSpec(
    system="C", signal="B1", name="BeiDou B1I",
    carrier_freq_hz=1_561_098_000.0, code_rate_cps=2.046e6,
    code_length_chips=2046, code_period_s=1e-3, bit_period_ms=20, prn_max=37,
    secondary_code="00000100110101001110",  # NH20 on MEO/IGSO
)

BEIDOU_B3I = SignalSpec(
    system="C", signal="B3", name="BeiDou B3I",
    carrier_freq_hz=1_268_520_000.0, code_rate_cps=10.23e6,
    code_length_chips=10230, code_period_s=1e-3, bit_period_ms=20, prn_max=37,
    secondary_code="00000100110101001110",
)

SIGNALS: dict[str, SignalSpec] = {
    s.signal: s
    for s in (
        GPS_L1_CA, GPS_L2_CM, GPS_L5_I, GALILEO_E1_B, GALILEO_E5A_I,
        GLONASS_L1_CA, GLONASS_L2_CA, BEIDOU_B1I, BEIDOU_B3I,
    )
}

