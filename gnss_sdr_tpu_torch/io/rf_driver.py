"""RF front-end driver abstraction + mock driver.

Port of gnss_sdr_tpu/io/rf_driver.py (host code, copied): the UHD and
Soapy loaders raise when their vendor libraries are absent, as there.

Reference analog: the hardware signal-source adapters
(``uhd_signal_source.cc:60`` USRP, ``osmosdr_signal_source.cc:47``
RTL-SDR/HackRF/bladeRF, ``plutosdr_signal_source.cc``,
``fmcomms2_signal_source.cc``). The reference links the vendor driver
libraries at build time; here the driver is a small runtime interface so

  * real drivers (python ``uhd`` / ``SoapySDR`` / ``iio``) load lazily and
    only when a conf actually selects them, and
  * a :class:`MockRfDriver` lets every hardware conf file LOAD, CONFIGURE
    (rate/frequency/gain/antenna checked and recorded) and STREAM
    deterministically without hardware — either synthesized noise or a
    playback capture (``SignalSource.mock_capture=...``), so the live-RF
    path is testable end-to-end in CI.

Driver interface (duck-typed):
  configure(cfg: RfConfig) -> None     may raise on invalid settings
  start() -> None
  read(n) -> np.complex64[n]           blocking, n samples of baseband IQ
  stop() -> None
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib

import numpy as np

log = logging.getLogger("gnss_sdr_tpu_torch")


@dataclasses.dataclass
class RfConfig:
    """Front-end settings common to every adapter (reference: the conf
    keys each hardware adapter constructor reads)."""

    sampling_frequency: float = 4_000_000.0
    center_freq_hz: float = 1_575_420_000.0
    gain_db: float = 40.0
    rf_gain_db: float = 0.0            # osmosdr split gain stages
    if_gain_db: float = 0.0
    agc: bool = False
    antenna: str = ""                  # e.g. UHD "TX/RX" | "RX2"
    subdevice: str = ""                # UHD subdev spec, e.g. "A:0"
    bandwidth_hz: float = 0.0          # analog bandwidth (Pluto/FMComms)
    device_args: str = ""              # driver-specific address/args string


class MockRfDriver:
    """Deterministic stand-in for a hardware front-end.

    Streams complex64 baseband at the configured rate: Gaussian noise whose
    amplitude follows the configured gain (1 LSB-ish noise floor scaled by
    10^(gain/20)/10^(40/20)), or a playback capture when ``playback`` is
    given — the mock equivalent of antenna input, letting a UHD conf
    produce real fixes from a synthesized scenario.
    """

    def __init__(self, playback: np.ndarray | str | pathlib.Path | None = None,
                 seed: int = 12345):
        self.cfg: RfConfig | None = None
        self.started = False
        self.samples_delivered = 0
        self._rng = np.random.default_rng(seed)
        if playback is not None and not isinstance(playback, np.ndarray):
            playback = np.fromfile(str(playback), dtype=np.complex64)
        self._playback = (None if playback is None
                          else np.asarray(playback, np.complex64))
        self._pos = 0

    # ------------------------------------------------------------- driver API
    def configure(self, cfg: RfConfig) -> None:
        if cfg.sampling_frequency <= 0:
            raise ValueError("sampling_frequency must be positive")
        if not (1e6 <= cfg.center_freq_hz <= 10e9):
            raise ValueError(
                f"center frequency {cfg.center_freq_hz} Hz outside the "
                "tuner range (mock models a 1 MHz - 10 GHz front-end)")
        self.cfg = cfg
        log.info("mock RF front-end: fs=%.0f Hz freq=%.0f Hz gain=%.1f dB "
                 "antenna=%r subdev=%r", cfg.sampling_frequency,
                 cfg.center_freq_hz, cfg.gain_db, cfg.antenna, cfg.subdevice)

    def start(self) -> None:
        if self.cfg is None:
            raise RuntimeError("configure() before start()")
        self.started = True

    def read(self, n: int) -> np.ndarray:
        if not self.started:
            raise RuntimeError("start() before read()")
        self.samples_delivered += n
        if self._playback is not None:
            out = self._playback[self._pos: self._pos + n]
            self._pos += len(out)
            return out
        amp = 10.0 ** ((self.cfg.gain_db - 40.0) / 20.0)
        return (amp * (self._rng.standard_normal(n)
                       + 1j * self._rng.standard_normal(n))
                ).astype(np.complex64)

    def stop(self) -> None:
        self.started = False


def _load_uhd_driver():
    try:
        import uhd  # noqa: F401  (vendor driver; absent in this build)
    except ImportError as e:
        raise ImportError(
            "UHD python driver not installed — install 'uhd' or set "
            "SignalSource.driver=mock to stream from the mock front-end"
        ) from e
    raise NotImplementedError(
        "real UHD streaming requires hardware; driver detected but "
        "unsupported in this environment")


def _load_soapy_driver():
    try:
        import SoapySDR  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "SoapySDR python driver not installed — install 'SoapySDR' or "
            "set SignalSource.driver=mock") from e
    raise NotImplementedError(
        "real SoapySDR streaming requires hardware; driver detected but "
        "unsupported in this environment")


DRIVERS = {
    "mock": MockRfDriver,
    "uhd": _load_uhd_driver,
    "soapy": _load_soapy_driver,
    "osmosdr": _load_soapy_driver,     # osmosdr devices reachable via Soapy
    "iio": _load_soapy_driver,         # Pluto/FMComms via Soapy's PlutoSDR
}


def make_driver(kind: str, **kwargs):
    if kind not in DRIVERS:
        raise ValueError(f"unknown RF driver {kind!r}; one of {sorted(DRIVERS)}")
    return DRIVERS[kind](**kwargs) if kind == "mock" else DRIVERS[kind]()


class RfSignalSource:
    """SignalSource facade over an RF driver (same read API as the file
    sources): configures + starts the driver, streams complex64."""

    def __init__(self, driver, cfg: RfConfig):
        self.driver = driver
        self.cfg = cfg
        self.fs = cfg.sampling_frequency
        driver.configure(cfg)
        driver.start()

    def read(self, n: int) -> np.ndarray:
        return self.driver.read(n)

    def close(self) -> None:
        self.driver.stop()
