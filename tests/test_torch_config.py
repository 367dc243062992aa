"""The port's INI binding (gnss_sdr_tpu_torch.config) and rate conditioner
(gnss_sdr_tpu_torch.ops.fir) against the JAX package's, on the CPU.

Every ``conf/*.conf`` parses to a ``ReceiverConfig`` whose
``dataclasses.asdict`` equals the JAX package's exactly; a conf that selects
something the port lacks raises ``NotImplementedError`` naming the field or
key, at ``Receiver(cfg, device="cpu")`` or at the binding step that reads
the key; all 16 shipped confs run whole. Registry errors carry the JAX package's messages. The streaming
FIR and fractional resampler equal JAX's ``ops/fir.py`` over several
consecutive blocks of seeded input within rtol 1e-5 / atol 1e-5, and the
rate conditioner reads the same block lengths.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.config import registry as jreg
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.config import registry as treg
from gnss_sdr_tpu_torch.ops import fir as tfir
from gnss_sdr_tpu_torch.receiver import receiver as trx

torch.set_num_threads(1)   # one thread per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFS = sorted((ROOT / "conf").glob("*.conf"))

# conf -> (where the port refuses it, the key or field named), or None when
# the port runs it whole
UNPORTED = {
    "beidou_b1i": None,
    "beidou_b3i": None,
    "galileo_e5a": None,
    "glonass_l1": None,
    "glonass_l2": None,
    "gps_l2c": None,
    "gps_l5": None,
    "hybrid_gps_galileo": None,
    "ppp_static": None,           # PPP (test_torch_outputs attaches it)
    "gps_l1_notch": None,         # the notch on the receiver's device
    "labsat3": None,              # the LabSat 3 source, decimated 8:1
    "gps_l1_file": None,
    "gps_l1_realtime_tpu": None,
    "gps_l1_supl": None,          # SUPL: see test_torch_cli / test_torch_supl
    "rtk_rover": None,            # RTK (test_torch_outputs attaches them)
    "rtk_rover_ntrip": None,
}


def test_every_conf_is_listed():
    assert sorted(UNPORTED) == [c.stem for c in CONFS]


@pytest.mark.parametrize("conf", CONFS, ids=lambda p: p.stem)
def test_conf_parses_as_jax(conf):
    want = jini.receiver_config_from_ini(jini.FileConfiguration(conf))
    tconf = tini.FileConfiguration(conf)
    got = tini.receiver_config_from_ini(tconf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    refusal = UNPORTED[conf.stem]
    if refusal is None:
        treg.check_ported(tconf, got.signal_plan)
        trx.Receiver(got, device="cpu")
    elif refusal[0] == "receiver":
        with pytest.raises(NotImplementedError, match=refusal[1]):
            trx.Receiver(got, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match=refusal[1]):
            treg.check_ported(tconf, got.signal_plan)


def _both(text: str):
    return (jini.InMemoryConfiguration(jini._parse(text)),
            tini.InMemoryConfiguration(tini._parse(text)))


def test_registry_errors_match_jax():
    for text in ("Acquisition_1C.implementation=No_Such_Acquisition\n",
                 "Tracking_1C.implementation=GPS_L2_M_DLL_PLL_Tracking\n",
                 "PVT.implementation=Fancy_PVT\n",
                 "SignalSource.implementation=Tape_Signal_Source\n",
                 "Channels_1B.count=4\n"
                 "TelemetryDecoder_1B.implementation=GPS_L1_CA_Telemetry_"
                 "Decoder\n"):
        jc, tc = _both(text)
        with pytest.raises(jreg.UnknownBlockError) as je:
            jini.receiver_config_from_ini(jc)
        with pytest.raises(treg.UnknownBlockError) as te:
            tini.receiver_config_from_ini(tc)
        assert str(te.value) == str(je.value)


def test_check_ported_names_role_and_block():
    # the Kalman tracking block and the SBAS decoder are ported: they bind
    # as JAX binds them and pass
    for text in ("Tracking_1C.implementation=GPS_L1_CA_KF_Tracking\n",
                 "Channels_1C.count=4\nTelemetryDecoder_1C.implementation="
                 "SBAS_L1_Telemetry_Decoder\n"):
        jc, tc = _both(text)
        cfg = tini.receiver_config_from_ini(tc)
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jini.receiver_config_from_ini(jc)))
        treg.check_ported(tc, cfg.signal_plan)
    # every source and input filter JAX builds passes, a hardware front-end
    # with the mock driver among them
    for text in ("SignalSource.implementation=Custom_UDP_Signal_Source\n",
                 "SignalSource.implementation=UHD_Signal_Source\n"
                 "SignalSource.driver=mock\n",
                 "InputFilter.implementation=Beamformer_Filter\n"):
        jc, tc = _both(text)
        cfg = tini.receiver_config_from_ini(tc)
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jini.receiver_config_from_ini(jc)))
        treg.check_ported(tc, cfg.signal_plan)
    # the multi-file source (the multi-source receiver) still raises
    named = "SignalSource.implementation=Multichannel_File_Signal_Source"
    jc, tc = _both(named + "\n")
    cfg = tini.receiver_config_from_ini(tc)
    assert (dataclasses.asdict(cfg)
            == dataclasses.asdict(jini.receiver_config_from_ini(jc)))
    with pytest.raises(NotImplementedError, match=named):
        treg.check_ported(tc, cfg.signal_plan)
    # and so does a front-end driver other than the mock
    _, tc = _both("SignalSource.implementation=UHD_Signal_Source\n")
    with pytest.raises(NotImplementedError, match="driver uhd"):
        tini.receiver_config_from_ini(tc)


def test_binding_details(tmp_path):
    """upload_bits: absent -> 0, a valid value taken, a bad one refused
    (JAX drops it); PVT.trop_model / iono_model OFF; an input filter built
    on the given device, an unknown one and multi-source confs refused by
    key."""
    _, tc = _both("")
    assert tini.receiver_config_from_ini(tc).upload_bits == 0
    _, tc = _both("GNSS-SDR.upload_bits=4\n")
    assert tini.receiver_config_from_ini(tc).upload_bits == 4
    jc, tc = _both("GNSS-SDR.upload_bits=16\n")
    assert jini.receiver_config_from_ini(jc).upload_bits == 0
    with pytest.raises(ValueError, match="GNSS-SDR.upload_bits=16"):
        tini.receiver_config_from_ini(tc)
    _, tc = _both("PVT.trop_model=OFF\nPVT.iono_model=OFF\n")
    cfg = tini.receiver_config_from_ini(tc)
    assert not cfg.pvt_apply_tropo and not cfg.pvt_apply_iono
    for impl in ("Pass_Through", "Fir_Filter"):
        _, tc = _both(f"InputFilter.implementation={impl}\n")
        assert tini.input_filter_from_ini(tc) is None
    _, tc = _both("InputFilter.implementation=Pulse_Blanking_Filter\n")
    flt = tini.input_filter_from_ini(tc, device="cpu")
    assert flt.name == "Pulse_Blanking_Filter"
    assert flt.device == torch.device("cpu")
    _, tc = _both("InputFilter.implementation=Median_Filter\n")
    with pytest.raises(NotImplementedError, match="Median_Filter"):
        tini.input_filter_from_ini(tc, device="cpu")
    _, tc = _both("")
    assert tini.multisource_from_ini(tc) is None
    _, tc = _both("Receiver.sources_count=2\n")
    with pytest.raises(NotImplementedError, match="Receiver.sources_count=2"):
        tini.multisource_from_ini(tc)


def test_source_from_ini_matches_jax(tmp_path):
    path = tmp_path / "cap.dat"
    np.arange(4000, dtype=np.int16).tofile(path)
    text = (f"SignalSource.implementation=File_Signal_Source\n"
            f"SignalSource.filename={path}\n"
            f"SignalSource.item_type=ishort\n"
            f"SignalSource.sampling_frequency=4000000\n"
            f"SignalSource.samples=1500\nSignalSource.repeat=true\n")
    jc, tc = _both(text)
    js, ts = jini.source_from_ini(jc), tini.source_from_ini(tc)
    for attr in ("path", "item_type", "fs", "repeat", "total_samples"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    np.testing.assert_array_equal(ts.read(2000), js.read(2000))
    # every other source is held against JAX in test_torch_sources; what
    # the JAX package does not build raises in both, naming the source
    for impl in ("Multichannel_File_Signal_Source", "Tape_Signal_Source"):
        jc, tc = _both(f"SignalSource.implementation={impl}\n")
        with pytest.raises(NotImplementedError, match=impl) as je:
            jini.source_from_ini(jc)
        with pytest.raises(NotImplementedError, match=impl) as te:
            tini.source_from_ini(tc)
        assert str(te.value) == str(je.value)


def _conditioners(fs_in, fs_out, jfir):
    ratio = fs_in / fs_out
    decim = int(round(ratio))
    if abs(ratio - decim) < 1e-9:
        taps = jfir.design_lowpass(decim * 16 + 1, 0.8 / decim)
        np.testing.assert_array_equal(
            tfir.design_lowpass(decim * 16 + 1, 0.8 / decim), taps)
        return (jfir.StreamingFir(taps, decim=decim),
                tfir.StreamingFir(taps, decim=decim))
    return (jfir.StreamingFractionalResampler(fs_in, fs_out),
            tfir.StreamingFractionalResampler(fs_in, fs_out))


@pytest.mark.parametrize("fs_in,fs_out", [(4e6, 2e6), (6e6, 2e6),
                                          (4.092e6, 2e6), (2e6, 2.046e6)])
def test_conditioner_matches_jax(fs_in, fs_out):
    from gnss_sdr_tpu.ops import fir as jfir

    a, b = _conditioners(fs_in, fs_out, jfir)
    rng = np.random.default_rng(7)
    for n in (20000, 20011, 19990, 20000):
        x = (rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(np.complex64)
        want, got = np.asarray(a(x)), b(x)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rate_conditioner_block_lengths_match_jax():
    from gnss_sdr_tpu.receiver import receiver as jrx

    for fs_in, fs_out in ((2e6, 2e6), (4e6, 2e6), (8e6, 2e6),
                          (4.092e6, 2e6), (2e6, 2.046e6)):
        jc, jlen = jrx.make_rate_conditioner(fs_in, fs_out, 200000)
        tc, tlen = trx.make_rate_conditioner(fs_in, fs_out, 200000, "cpu")
        assert tlen == jlen and (tc is None) == (jc is None)


def test_check_ported_galileo_e1_names():
    """The Galileo E1 blocks of this receiver (PCPS acquisition, VEML
    tracking, the E1-B telemetry decoder) pass, and so do the GLONASS and
    BeiDou B3I blocks; the E1 blocks the port lacks and the other
    constellations' TCP-connector and Kalman tracking still raise."""
    ok = ("Channels_1B.count=4\n"
          "Acquisition_1B.implementation=Galileo_E1_PCPS_Ambiguous_"
          "Acquisition\n"
          "Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking\n"
          "Tracking_1B.track_pilot=true\n"
          "TelemetryDecoder_1B.implementation=Galileo_E1B_Telemetry_"
          "Decoder\n")
    jc, tc = _both(ok)
    cfg = tini.receiver_config_from_ini(tc)
    assert (dataclasses.asdict(cfg)
            == dataclasses.asdict(jini.receiver_config_from_ini(jc)))
    assert cfg.signal == "1B" and cfg.track_pilot
    treg.check_ported(tc, cfg.signal_plan)
    trx.Receiver(cfg, device="cpu")
    for text, named in (
            ("Channels_1B.count=4\nAcquisition_1B.implementation="
             "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition\n",
             "Acquisition_1B.implementation=Galileo_E1_PCPS_8ms"),
            ("Channels_1B.count=4\nTracking_1B.implementation="
             "Galileo_E1_TCP_CONNECTOR_Tracking\n",
             "Tracking_1B.implementation=Galileo_E1_TCP_CONNECTOR"),
            ("Channels_1C.count=4\nTracking_1C.implementation="
             "GPS_L1_CA_TCP_CONNECTOR_Tracking\n",
             "Tracking_1C.implementation=GPS_L1_CA_TCP_CONNECTOR")):
        _, tc = _both(text)
        cfg = tini.receiver_config_from_ini(tc)
        with pytest.raises(NotImplementedError, match=named):
            treg.check_ported(tc, cfg.signal_plan)
    for text in ("Channels_1G.count=4\nTracking_1G.implementation="
                 "GLONASS_L1_CA_DLL_PLL_Tracking\n",
                 "Channels_1G.count=4\nTelemetryDecoder_1G.implementation="
                 "GLONASS_L1_CA_Telemetry_Decoder\n",
                 "Channels_2G.count=4\nTracking_2G.implementation="
                 "GLONASS_L2_CA_DLL_PLL_C_Aid_Tracking\n",
                 "Channels_B3.count=4\nAcquisition_B3.implementation="
                 "BEIDOU_B3I_PCPS_Acquisition\n"):
        _, tc = _both(text)
        cfg = tini.receiver_config_from_ini(tc)
        treg.check_ported(tc, cfg.signal_plan)
        trx.Receiver(cfg, device="cpu")


def test_wideband_confs_bind_and_run():
    """The shipped GPS L5 and Galileo E5a confs: the same ReceiverConfig as
    the JAX binding (L5Q pilot tracking; E5a's noncoherent I/Q CAF
    acquisition with its window and both components, bound as JAX binds
    them), every block ported, a receiver built on the CPU."""
    for stem, signal, n_ch in (("gps_l5", "L5", 6), ("galileo_e5a", "5X", 5)):
        conf = ROOT / "conf" / f"{stem}.conf"
        want = jini.receiver_config_from_ini(jini.FileConfiguration(conf))
        tconf = tini.FileConfiguration(conf)
        got = tini.receiver_config_from_ini(tconf)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.signal, got.n_channels) == (signal, n_ch)
        treg.check_ported(tconf, got.signal_plan)
        rx = trx.Receiver(got, device="cpu")
        g, = rx.groups
        assert g.trk_cfg.n_max == (11064 if signal == "L5" else 12064)
        if signal == "L5":
            assert got.track_pilot and g.trk_cfg.track_pilot
            assert g.code_tables.shape == (6, 2, 10230)
        else:
            # the variant's keys bind into the group's parameters
            assert dict(dict(got.group_params)["5X"]) == dict(
                acq_variant="e5a_caf", acq_caf_window_hz=3000.0,
                acq_both_components=True, acq_doppler_max_hz=5000.0,
                acq_doppler_step_hz=125.0, pll_bw_hz=25.0, dll_bw_hz=2.0)
            assert (g.rx_cfg.acq_variant, g.rx_cfg.acq_caf_window_hz,
                    g.rx_cfg.acq_both_components) == ("e5a_caf", 3000.0, True)
            assert rx._acq_window(g) == (12000, 12000)


def test_acquisition_variants_refused_but_e5a_caf():
    """acq_variant="e5a_caf" runs; the other variants still raise, naming
    the field, on GLONASS and B3I too, whose plain PCPS runs."""
    base = dict(fs=12.0e6, n_channels=2, prns=(1, 2))
    trx.Receiver(trx.ReceiverConfig(signal="5X", acq_variant="e5a_caf",
                                    **base), device="cpu")
    for variant in ("e1_8ms", "quicksync", "cccwsr", "tong", "pcps_8ms"):
        with pytest.raises(NotImplementedError, match="acq_variant"):
            trx.Receiver(trx.ReceiverConfig(signal="5X", acq_variant=variant,
                                            **base), device="cpu")
    for signal in ("1G", "2G", "B3"):
        trx.Receiver(trx.ReceiverConfig(signal=signal, **base), device="cpu")
        with pytest.raises(NotImplementedError, match="acq_variant"):
            trx.Receiver(trx.ReceiverConfig(signal=signal, acq_variant="tong",
                                            **base), device="cpu")
