"""Block-name registry: the reference's ``implementation=`` vocabulary.

Port of gnss_sdr_tpu/config/registry.py (the reference's
``GNSSBlockFactory::GetBlock``, ``src/core/receiver/gnss_block_factory.cc``):
the same tables, so a conf names the same blocks in both packages, and
unknown names raise :class:`UnknownBlockError` at config time as there.

:func:`check_ported` is the port's own: a name the JAX package accepts but
whose block this port has not ported raises ``NotImplementedError`` naming
the role and the block. :func:`validate_conf` stays as in the JAX package
(it does not refuse unported names), so every conf parses to the same
``ReceiverConfig`` in both packages; ``Receiver`` then refuses unported
fields itself.
"""

from __future__ import annotations

# name -> (signal, ReceiverConfig overrides)
ACQUISITIONS: dict[str, tuple[str, dict]] = {
    "GPS_L1_CA_PCPS_Acquisition": ("1C", {}),
    "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler": ("1C", {"acq_two_step": True}),
    "GPS_L1_CA_PCPS_Tong_Acquisition": ("1C", {}),
    "GPS_L1_CA_PCPS_QuickSync_Acquisition": ("1C", {}),
    "GPS_L1_CA_PCPS_Assisted_Acquisition": ("1C", {"acq_assisted": True}),
    "GPS_L2_M_PCPS_Acquisition": ("2S", {}),
    "GPS_L5i_PCPS_Acquisition": ("L5", {}),
    "Galileo_E1_PCPS_Ambiguous_Acquisition": ("1B", {}),
    "Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition": ("1B", {}),
    "Galileo_E1_PCPS_Tong_Ambiguous_Acquisition": ("1B", {}),
    "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition": ("1B", {}),
    "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition": (
        "1B", {"acq_variant": "e1_8ms"}),
    "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF": (
        "5X", {"acq_variant": "e5a_caf"}),
    "Galileo_E5a_Pcps_Acquisition": ("5X", {}),
    "GLONASS_L1_CA_PCPS_Acquisition": ("1G", {}),
    "GLONASS_L2_CA_PCPS_Acquisition": ("2G", {}),
    "BEIDOU_B1I_PCPS_Acquisition": ("B1", {}),
    "BEIDOU_B3I_PCPS_Acquisition": ("B3", {}),
}

TRACKINGS: dict[str, tuple[str, dict]] = {
    "GPS_L1_CA_DLL_PLL_Tracking": ("1C", {}),
    "GPS_L1_CA_KF_Tracking": ("1C", {"carrier_kf": True}),
    # loop filters in an external process over TCP (research block)
    "GPS_L1_CA_TCP_CONNECTOR_Tracking": ("1C", {"tcp_connector": True}),
    "Galileo_E1_TCP_CONNECTOR_Tracking": ("1B", {"tcp_connector": True}),
    "GPS_L1_CA_DLL_PLL_C_Aid_Tracking": ("1C", {}),
    "GPS_L2_M_DLL_PLL_Tracking": ("2S", {}),
    "GPS_L5_DLL_PLL_Tracking": ("L5", {}),
    "GPS_L5i_DLL_PLL_Tracking": ("L5", {}),   # factory's pre-0.0.10 spelling
    "Galileo_E1_DLL_PLL_VEML_Tracking": ("1B", {}),
    "Galileo_E5a_DLL_PLL_Tracking": ("5X", {}),
    "GLONASS_L1_CA_DLL_PLL_Tracking": ("1G", {}),
    "GLONASS_L1_CA_DLL_PLL_C_Aid_Tracking": ("1G", {}),
    "GLONASS_L2_CA_DLL_PLL_Tracking": ("2G", {}),
    "GLONASS_L2_CA_DLL_PLL_C_Aid_Tracking": ("2G", {}),
    "BEIDOU_B1I_DLL_PLL_Tracking": ("B1", {}),
    "BEIDOU_B3I_DLL_PLL_Tracking": ("B3", {}),
}

TELEMETRIES: dict[str, str] = {
    "GPS_L1_CA_Telemetry_Decoder": "1C",
    # SBAS rides an L1 C/A channel (PRN 120-138, 500 sps MOPS stream)
    "SBAS_L1_Telemetry_Decoder": "1C",
    "GPS_L2C_Telemetry_Decoder": "2S",
    "GPS_L5_Telemetry_Decoder": "L5",
    "Galileo_E1B_Telemetry_Decoder": "1B",
    "Galileo_E5a_Telemetry_Decoder": "5X",
    "GLONASS_L1_CA_Telemetry_Decoder": "1G",
    "GLONASS_L2_CA_Telemetry_Decoder": "2G",
    "BEIDOU_B1I_Telemetry_Decoder": "B1",
    "BEIDOU_B3I_Telemetry_Decoder": "B3",
}

OBSERVABLES = {"Hybrid_Observables", "GPS_L1_CA_Observables",
               "Galileo_E1B_Observables", "GPS_L2C_Observables",
               "Galileo_E5A_Observables", "Pass_Through"}
PVTS = {"RTKLIB_PVT", "GPS_L1_CA_PVT", "Hybrid_PVT", "Galileo_E1_PVT",
        "Pass_Through"}

SOURCES = {"File_Signal_Source", "Custom_UDP_Signal_Source",
           "RtlTcp_Signal_Source", "Labsat_Signal_Source",
           "Spir_File_Signal_Source", "Spir_GSS6450_File_Signal_Source",
           "Raw_Array_Signal_Source", "Nsr_File_Signal_Source",
           "Two_Bit_Packed_File_Signal_Source",
           "Two_Bit_Cpx_File_Signal_Source",
           "Multichannel_File_Signal_Source"}
# hardware front-ends (the JAX package streams them through its
# io.rf_driver abstraction; not ported)
HARDWARE_SOURCES = {"UHD_Signal_Source", "Osmosdr_Signal_Source",
                    "Plutosdr_Signal_Source", "Fmcomms2_Signal_Source",
                    "Ad9361_Fpga_Signal_Source", "Flexiband_Signal_Source",
                    "GN3S_Signal_Source"}
# default driver library per hardware adapter (reference: which vendor lib
# each adapter links)
HARDWARE_DRIVER_DEFAULT = {
    "UHD_Signal_Source": "uhd",
    "Osmosdr_Signal_Source": "osmosdr",
    "Plutosdr_Signal_Source": "iio",
    "Fmcomms2_Signal_Source": "iio",
    "Ad9361_Fpga_Signal_Source": "iio",
    "Flexiband_Signal_Source": "soapy",
    "GN3S_Signal_Source": "soapy",
}

DATA_TYPE_ADAPTERS = {"Byte_To_Short", "Ibyte_To_Cbyte", "Ibyte_To_Complex",
                      "Ibyte_To_Cshort", "Ishort_To_Complex",
                      "Ishort_To_Cshort", "Pass_Through"}
INPUT_FILTERS = {"Pass_Through", "Fir_Filter", "Freq_Xlating_Fir_Filter",
                 "Notch_Filter", "Notch_Filter_Lite", "Pulse_Blanking_Filter",
                 "Beamformer_Filter"}
RESAMPLERS = {"Direct_Resampler", "Mmse_Resampler", "Fractional_Resampler",
              "Pass_Through"}
CONDITIONERS = {"Signal_Conditioner", "Array_Signal_Conditioner",
                "Pass_Through"}


class UnknownBlockError(ValueError):
    pass


def _check(role: str, name: str, table, signal: str | None = None) -> dict:
    """Validate one implementation name; returns config overrides."""
    if isinstance(table, dict):
        if name not in table:
            raise UnknownBlockError(
                f"{role}.implementation={name}: unknown block "
                f"(reference gnss_block_factory has no TPU mapping here)")
        entry = table[name]
        if isinstance(entry, tuple):
            sig, overrides = entry
            if signal is not None and sig != signal:
                raise UnknownBlockError(
                    f"{role}.implementation={name} serves signal {sig!r}, "
                    f"but the channel group is {signal!r}")
            return dict(overrides)
        if signal is not None and entry != signal:
            raise UnknownBlockError(
                f"{role}.implementation={name} serves signal {entry!r}, "
                f"but the channel group is {signal!r}")
        return {}
    if name not in table:
        raise UnknownBlockError(f"{role}.implementation={name}: unknown block")
    return {}


def validate_conf(conf, plan: list) -> dict:
    """Validate every implementation name in ``conf`` against the registry.

    ``plan`` is the [(signal, count), ...] channel plan. Returns the merged
    ReceiverConfig overrides contributed by the FIRST group's acquisition/
    tracking names (fine-Doppler -> two-step, KF -> carrier_kf, ...).
    Raises UnknownBlockError for names the factory cannot build.
    """
    overrides: dict = {}
    for gi, entry in enumerate(plan):
        signal = entry[0]
        acq = conf.property(f"Acquisition_{signal}.implementation", "")
        trk = conf.property(f"Tracking_{signal}.implementation", "")
        tlm = conf.property(f"TelemetryDecoder_{signal}.implementation", "")
        if acq:
            ov = _check(f"Acquisition_{signal}", acq, ACQUISITIONS, signal)
            if gi == 0:
                overrides.update(ov)
        if trk:
            ov = _check(f"Tracking_{signal}", trk, TRACKINGS, signal)
            if gi == 0:
                overrides.update(ov)
        if tlm:
            _check(f"TelemetryDecoder_{signal}", tlm, TELEMETRIES, signal)

    obs = conf.property("Observables.implementation", "")
    if obs:
        _check("Observables", obs, OBSERVABLES)
    pvt = conf.property("PVT.implementation", "")
    if pvt:
        _check("PVT", pvt, PVTS)
    src = conf.property("SignalSource.implementation", "")
    if src:
        if src in HARDWARE_SOURCES:
            drv = conf.property("SignalSource.driver",
                                HARDWARE_DRIVER_DEFAULT[src])
            if drv != "mock":
                # the JAX package raises UnknownBlockError here when the
                # driver's vendor library is missing; the port has no
                # front-end drivers at all
                raise NotImplementedError(
                    f"SignalSource.implementation={src} (driver {drv}): RF "
                    f"front-ends are not ported yet")
        else:
            _check("SignalSource", src, SOURCES)
    flt = conf.property("InputFilter.implementation", "")
    if flt:
        _check("InputFilter", flt, INPUT_FILTERS)
    dta = conf.property("DataTypeAdapter.implementation", "")
    if dta:
        _check("DataTypeAdapter", dta, DATA_TYPE_ADAPTERS)
    rsm = conf.property("Resampler.implementation", "")
    if rsm:
        _check("Resampler", rsm, RESAMPLERS)
    cond = conf.property("SignalConditioner.implementation", "")
    if cond:
        _check("SignalConditioner", cond, CONDITIONERS)
    # multi-source configs: per-source SignalSourceK / conditioner chains
    # (reference gnss_block_factory instantiating blocks per source index)
    for k in range(int(conf.property("Receiver.sources_count", 1))):
        for role, table in ((f"SignalSource{k}", SOURCES),
                            (f"InputFilter{k}", INPUT_FILTERS),
                            (f"DataTypeAdapter{k}", DATA_TYPE_ADAPTERS),
                            (f"Resampler{k}", RESAMPLERS),
                            (f"SignalConditioner{k}", CONDITIONERS)):
            name = conf.property(f"{role}.implementation", "")
            if name:
                if table is SOURCES and name in HARDWARE_SOURCES:
                    raise UnknownBlockError(
                        f"{role}.implementation={name} needs an RF "
                        "front-end driver not present in this build")
                _check(role, name, table)
    return overrides


# what the port has: every other name the tables accept raises in
# check_ported (the GPS L1 C/A, GPS L2C, GPS L5, Galileo E1-B, Galileo E5a
# and BeiDou B1I receivers with PCPS acquisition and E5a's noncoherent I/Q
# CAF variant,
# their file / array sources and the rate conditioner; observables and PVT
# names all select the one engine)
PORTED_ACQUISITIONS = {n for n, (sig, ov) in ACQUISITIONS.items()
                       if sig == "1C"
                       or (sig in ("1B", "2S", "L5", "5X", "B1", "B3", "1G",
                                   "2G") and not ov)
                       or ov == {"acq_variant": "e5a_caf"}}
PORTED_TRACKINGS = {"GPS_L1_CA_DLL_PLL_Tracking",
                    "GPS_L1_CA_DLL_PLL_C_Aid_Tracking",
                    "GPS_L1_CA_KF_Tracking",
                    "GPS_L2_M_DLL_PLL_Tracking",
                    "GPS_L5_DLL_PLL_Tracking", "GPS_L5i_DLL_PLL_Tracking",
                    "Galileo_E1_DLL_PLL_VEML_Tracking",
                    "Galileo_E5a_DLL_PLL_Tracking",
                    "GLONASS_L1_CA_DLL_PLL_Tracking",
                    "GLONASS_L1_CA_DLL_PLL_C_Aid_Tracking",
                    "GLONASS_L2_CA_DLL_PLL_Tracking",
                    "GLONASS_L2_CA_DLL_PLL_C_Aid_Tracking",
                    "BEIDOU_B1I_DLL_PLL_Tracking",
                    "BEIDOU_B3I_DLL_PLL_Tracking"}
PORTED_TELEMETRIES = {"GPS_L1_CA_Telemetry_Decoder",
                      "GPS_L2C_Telemetry_Decoder",
                      "GPS_L5_Telemetry_Decoder",
                      "Galileo_E1B_Telemetry_Decoder",
                      "Galileo_E5a_Telemetry_Decoder",
                      "GLONASS_L1_CA_Telemetry_Decoder",
                      "GLONASS_L2_CA_Telemetry_Decoder",
                      "BEIDOU_B1I_Telemetry_Decoder",
                      "BEIDOU_B3I_Telemetry_Decoder",
                      "SBAS_L1_Telemetry_Decoder"}
PORTED_SOURCES = {"File_Signal_Source"}
PORTED_INPUT_FILTERS = {"Pass_Through", "Fir_Filter"}


def check_ported(conf, plan: list) -> None:
    """Raise ``NotImplementedError`` naming the role and the block for every
    ``implementation=`` name of ``conf`` that the JAX package accepts but
    this port has not ported. ``plan``: the [(signal, count), ...] channel
    plan."""
    roles = []
    for entry in plan:
        signal = entry[0]
        roles += [(f"Acquisition_{signal}", PORTED_ACQUISITIONS),
                  (f"Tracking_{signal}", PORTED_TRACKINGS),
                  (f"TelemetryDecoder_{signal}", PORTED_TELEMETRIES)]
    roles += [("SignalSource", PORTED_SOURCES),
              ("InputFilter", PORTED_INPUT_FILTERS)]
    for role, ported in roles:
        name = conf.property(f"{role}.implementation", "")
        if name and name not in ported:
            raise NotImplementedError(
                f"{role}.implementation={name}: this block is not ported "
                f"yet")
