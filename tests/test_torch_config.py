"""The port's INI binding (gnss_sdr_tpu_torch.config) and rate conditioner
(gnss_sdr_tpu_torch.ops.fir) against the JAX package's, on the CPU.

Every ``conf/*.conf`` parses to a ``ReceiverConfig`` whose
``dataclasses.asdict`` equals the JAX package's exactly and builds a
receiver: all 16 shipped confs run whole. Every block name of the JAX
registry binds as JAX binds it (the E1 8 ms acquisition, the TCP-connector
tracking blocks, the multi-file source among them); only channels sharded
over several devices raise ``NotImplementedError``. Registry errors carry
the JAX package's messages, a missing RF driver library's among them. The
multi-source binding gives JAX's branches. The streaming
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

# the shipped confs, each run whole by the port (where else it is held)
SHIPPED = {
    "beidou_b1i": "", "beidou_b3i": "", "galileo_e5a": "", "glonass_l1": "",
    "glonass_l2": "", "gps_l2c": "", "gps_l5": "", "hybrid_gps_galileo": "",
    "ppp_static": "PPP: test_torch_outputs attaches it",
    "gps_l1_notch": "the notch on the receiver's device",
    "labsat3": "the LabSat 3 source, decimated 8:1",
    "gps_l1_file": "", "gps_l1_realtime_tpu": "",
    "gps_l1_supl": "SUPL: see test_torch_cli / test_torch_supl",
    "rtk_rover": "RTK: test_torch_outputs attaches them",
    "rtk_rover_ntrip": "",
}


def test_every_conf_is_listed():
    assert sorted(SHIPPED) == [c.stem for c in CONFS]


@pytest.mark.parametrize("conf", CONFS, ids=lambda p: p.stem)
def test_conf_parses_as_jax(conf):
    want = jini.receiver_config_from_ini(jini.FileConfiguration(conf))
    tconf = tini.FileConfiguration(conf)
    got = tini.receiver_config_from_ini(tconf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tini.multisource_from_ini(tconf) is None
    trx.Receiver(got, device="cpu")


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
    """Every block the JAX registry names binds as JAX binds it and builds
    a receiver: the Kalman tracking block, the SBAS decoder, every source
    (the multi-file one, and a hardware front-end with the mock driver,
    among them) and input filter; a front-end whose driver library is
    missing fails with JAX's error class and message."""
    for text in ("Tracking_1C.implementation=GPS_L1_CA_KF_Tracking\n",
                 "Channels_1C.count=4\nTelemetryDecoder_1C.implementation="
                 "SBAS_L1_Telemetry_Decoder\n",
                 "SignalSource.implementation=Custom_UDP_Signal_Source\n",
                 "SignalSource.implementation=UHD_Signal_Source\n"
                 "SignalSource.driver=mock\n",
                 "InputFilter.implementation=Beamformer_Filter\n",
                 "SignalSource.implementation="
                 "Multichannel_File_Signal_Source\n"):
        jc, tc = _both(text)
        cfg = tini.receiver_config_from_ini(tc)
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jini.receiver_config_from_ini(jc)))
        trx.Receiver(cfg, device="cpu")
    for drv in ("uhd", "soapy"):
        jc, tc = _both("SignalSource.implementation=UHD_Signal_Source\n"
                       f"SignalSource.driver={drv}\n")
        with pytest.raises(jreg.UnknownBlockError) as je:
            jini.receiver_config_from_ini(jc)
        with pytest.raises(treg.UnknownBlockError) as te:
            tini.receiver_config_from_ini(tc)
        assert str(te.value) == str(je.value)


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
    # two sources on two tiny files bind to JAX's branches
    f0, f1 = tmp_path / "a.ishort", tmp_path / "b.ishort"
    np.zeros(1000, np.int16).tofile(f0)
    np.zeros(1000, np.int16).tofile(f1)
    jc, tc = _both(
        "Receiver.sources_count=2\nChannels_1C.count=2\n"
        "Channels_1B.count=2\nChannel2.RF_channel_ID=1\n"
        + "".join(f"SignalSource{k}.filename={f}\n"
                  f"SignalSource{k}.item_type=ishort\n"
                  for k, f in enumerate((f0, f1))))
    (jb, jbase), (tb, tbase) = (jini.multisource_from_ini(jc),
                                tini.multisource_from_ini(tc, device="cpu"))
    assert dataclasses.asdict(tbase) == dataclasses.asdict(jbase)
    assert [dataclasses.asdict(b.receiver) for b in tb] == \
        [dataclasses.asdict(b.receiver) for b in jb]
    assert [(b.source.path, b.source.fs) for b in tb] == \
        [(b.source.path, b.source.fs) for b in jb]


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
    """The Galileo E1 blocks (PCPS and 8 ms acquisition, VEML and
    TCP-connector tracking, the E1-B telemetry decoder), GPS L1's
    TCP-connector tracking and the GLONASS and BeiDou B3I blocks bind as
    JAX binds them and build receivers."""
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
    trx.Receiver(cfg, device="cpu")
    for text, field, value in (
            ("Channels_1B.count=4\nAcquisition_1B.implementation="
             "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition\n",
             "acq_variant", "e1_8ms"),
            ("Channels_1B.count=4\nTracking_1B.implementation="
             "Galileo_E1_TCP_CONNECTOR_Tracking\nTracking_1B.port_ch0=0\n",
             "tcp_connector", True),
            ("Channels_1C.count=4\nTracking_1C.implementation="
             "GPS_L1_CA_TCP_CONNECTOR_Tracking\nTracking_1C.port_ch0=0\n",
             "tcp_connector", True)):
        jc, tc = _both(text)
        cfg = tini.receiver_config_from_ini(tc)
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jini.receiver_config_from_ini(jc)))
        rx = trx.Receiver(cfg, device="cpu")
        assert getattr(rx.groups[0].rx_cfg, field) == value
        rx.close()
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
    """Every acq_variant builds a receiver: "e5a_caf" and "e1_8ms" select
    their engines, and any other name (no block selects one) runs PCPS, as
    the JAX receiver does, on GLONASS and B3I too. A GPS L1 capture through
    both packages' receivers with acq_variant="tong": the same handoff
    record, and the port's records equal those of its own "pcps" run."""
    from gnss_sdr_tpu import constants as jconst
    from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
    from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
    from gnss_sdr_tpu.utils import generator

    base = dict(fs=12.0e6, n_channels=2, prns=(1, 2))
    trx.Receiver(trx.ReceiverConfig(signal="5X", acq_variant="e5a_caf",
                                    **base), device="cpu")
    trx.Receiver(trx.ReceiverConfig(signal="1B", acq_variant="e1_8ms",
                                    **base), device="cpu")
    for variant in ("quicksync", "cccwsr", "tong", "pcps_8ms"):
        trx.Receiver(trx.ReceiverConfig(signal="5X", acq_variant=variant,
                                        **base), device="cpu")
    for signal in ("1G", "2G", "B3"):
        trx.Receiver(trx.ReceiverConfig(signal=signal, acq_variant="tong",
                                        **base), device="cpu")
    rng = np.random.default_rng(2)
    bits = 1.0 - 2.0 * rng.integers(0, 2, 20)
    x = generator.generate(
        jconst.GPS_L1_CA, [generator.SatParams(
            prn=7, cn0_dbhz=47.0, doppler_hz=1234.0, code_delay_s=0.0004,
            data_bits=bits)], 2.0e6, 0.2, seed=11)
    kw = dict(signal="1C", fs=2.0e6, n_channels=1, prns=(7,), chunk_ms=100)
    records = {}
    for name, rx in (
            ("jax", JReceiver(JConfig(acq_variant="tong", **kw))),
            ("tong", trx.Receiver(trx.ReceiverConfig(acq_variant="tong",
                                                     **kw), device="cpu")),
            ("pcps", trx.Receiver(trx.ReceiverConfig(**kw), device="cpu"))):
        rx.process(x)
        ch = rx.groups[0].channels[0]
        assert (ch.state, ch.prn) == ("tracking", 7), name
        records[name] = list(ch.records)
    j, t = records["jax"][0], records["tong"][0]
    assert (t.abs_start_sample, t.epoch_index, t.code_freq,
            t.carrier_freq) == (j.abs_start_sample, j.epoch_index,
                                j.code_freq, j.carrier_freq)
    assert [dataclasses.astuple(r) for r in records["tong"]] == \
        [dataclasses.astuple(r) for r in records["pcps"]]
