"""Readers for the reference receiver's boost-serialization XML dumps.

Port of gnss_sdr_tpu/io/ref_xml.py (host code, copied with its imports
rewritten).

gnss-sdr persists its ephemeris and observable maps with
``boost::archive::xml_oarchive`` (``gnss_sdr_supl_client.cc``
save/load_ephemeris_xml; ``rtklib_solver_test.cc:437`` loads a
``GNSS-SDR_gnss_synchro_map``).  These are plain XML with one element per
struct field, so interop needs no boost: parse the tree and map the
reference's field names (``gps_ephemeris.h``, ``gnss_synchro.h:44``) onto
this package's domain models.  This lets a gnss-sdr user feed their
existing XML assistance/observable dumps straight into the TPU receiver,
and lets the test-suite validate PVT on the reference's own real-data
fixtures (``src/tests/data/rtklib_test/*.xml``).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

from gnss_sdr_tpu_torch import constants as C
from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris


def _fields(item: ET.Element) -> dict:
    out = {}
    for child in item:
        if len(child) == 0:
            out[child.tag] = child.text
    return out


def _map_items(root: ET.Element, map_tag: str):
    """Yield (key, second-element) pairs of a serialized std::map."""
    m = root.find(map_tag)
    if m is None:
        raise ValueError(f"no <{map_tag}> element in XML")
    for item in m.findall("item"):
        first = item.find("first")
        second = item.find("second")
        if first is not None and second is not None:
            yield int(first.text), second


def load_gps_ephemeris_xml(path: str) -> dict[tuple[str, int], KeplerEphemeris]:
    """Parse a ``GNSS-SDR_ephemeris_map`` XML (GPS LNAV fields, written by
    ``Gnss_Sdr_Supl_Client::save_ephemeris_xml``) into KeplerEphemeris
    keyed by ("G", prn) — directly usable by ``solve_pvt``."""
    root = ET.parse(path).getroot()
    out: dict[tuple[str, int], KeplerEphemeris] = {}
    for prn, second in _map_items(root, "GNSS-SDR_ephemeris_map"):
        f = _fields(second)

        def g(*names: str, default: float = 0.0) -> float:
            for n in names:
                if n in f:
                    return float(f[n])
            return default

        eph = KeplerEphemeris(
            prn=int(g("i_satellite_PRN", "PRN", default=prn)),
            week=int(g("i_GPS_week", "WN")),
            toc=g("d_Toc", "toc"), af0=g("d_A_f0", "af0"),
            af1=g("d_A_f1", "af1"), af2=g("d_A_f2", "af2"),
            tgd=g("d_TGD", "TGD"),
            toe=g("d_Toe", "toe"), sqrt_a=g("d_sqrt_A", "sqrtA"),
            e=g("d_e_eccentricity", "ecc"), m0=g("d_M_0", "M_0"),
            delta_n=g("d_Delta_n", "delta_n"),
            omega0=g("d_OMEGA0", "OMEGA_0"),
            omega_dot=g("d_OMEGA_DOT", "OMEGAdot"),
            omega=g("d_OMEGA", "omega"), i0=g("d_i_0", "i_0"),
            idot=g("d_IDOT", "idot"),
            cuc=g("d_Cuc", "Cuc"), cus=g("d_Cus", "Cus"),
            crc=g("d_Crc", "Crc"), crs=g("d_Crs", "Crs"),
            cic=g("d_Cic", "Cic"), cis=g("d_Cis", "Cis"),
            iode=int(g("d_IODE_SF2", "IODE_SF2")),
            iodc=int(g("d_IODC", "IODC")),
            health=int(g("i_SV_health", "SV_health")),
            ura=int(g("i_SV_accuracy", "SV_accuracy")),
        )
        out[("G", eph.prn)] = eph
    return out


@dataclasses.dataclass
class SynchroObs:
    """One entry of a serialized gnss_synchro map (``gnss_synchro.h:44``)."""

    system: str
    signal: str
    prn: int
    channel_id: int
    pseudorange_m: float
    rx_time_s: float
    carrier_doppler_hz: float
    carrier_phase_rads: float
    cn0_dbhz: float
    tow_at_symbol_ms: float
    interp_tow_ms: float
    valid_pseudorange: bool
    fs: float


def load_gnss_synchro_map_xml(path: str) -> list[SynchroObs]:
    """Parse a ``GNSS-SDR_gnss_synchro_map`` XML epoch (one observation per
    channel, as dumped by the reference's PVT test harness)."""
    root = ET.parse(path).getroot()
    out = []
    for _, second in _map_items(root, "GNSS-SDR_gnss_synchro_map"):
        f = _fields(second)
        # Signal is serialized as a char[3] count/item list
        sig_el = second.find("Signal")
        sig = ""
        if sig_el is not None:
            chars = [int(i.text) for i in sig_el.findall("item")]
            sig = "".join(chr(c) for c in chars if c > 0)
        out.append(SynchroObs(
            system=chr(int(f.get("System", "71"))),
            signal=sig,
            prn=int(f["PRN"]),
            channel_id=int(f.get("Channel_ID", "0")),
            pseudorange_m=float(f.get("Pseudorange_m", "0")),
            rx_time_s=float(f.get("RX_time", "0")),
            carrier_doppler_hz=float(f.get("Carrier_Doppler_hz", "0")),
            carrier_phase_rads=float(f.get("Carrier_phase_rads", "0")),
            cn0_dbhz=float(f.get("CN0_dB_hz", "45")),
            tow_at_symbol_ms=float(f.get("TOW_at_current_symbol_ms", "0")),
            interp_tow_ms=float(f.get("interp_TOW_ms", "0")),
            valid_pseudorange=f.get("Flag_valid_pseudorange", "0") in
            ("1", "true"),
            fs=float(f.get("fs", "0")),
        ))
    return out


_SIGNAL_FREQ = {(s.system, s.signal): s.carrier_freq_hz
                for s in C.SIGNALS.values()}


def synchro_to_obs_inputs(synchros: list[SynchroObs]):
    """Convert serialized observables into solver ``ObsInput``s.

    Transmit time in the SV clock is recovered the same way the reference's
    rtklib back end does (``rtklib_pntpos.cc``): t_tx = t_rx - PR/c, with
    t_rx the common RX_time tag of the epoch.
    """
    from gnss_sdr_tpu_torch.receiver.pvt.solver import ObsInput

    out = []
    for s in synchros:
        if not s.valid_pseudorange:
            continue
        freq = _SIGNAL_FREQ.get((s.system, s.signal),
                                C.GPS_L1_CA.carrier_freq_hz)
        out.append(ObsInput(
            prn=s.prn, pseudorange_m=s.pseudorange_m,
            doppler_hz=s.carrier_doppler_hz, carrier_freq_hz=freq,
            t_tx_sv=s.rx_time_s - s.pseudorange_m / C.SPEED_OF_LIGHT_M_S,
            cn0_dbhz=s.cn0_dbhz, system=s.system))
    return out
