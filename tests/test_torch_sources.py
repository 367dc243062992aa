"""The port's remaining signal sources (gnss_sdr_tpu_torch.io.sources /
io.native / io.rf_driver / io.ref_xml and ``config.ini.source_from_ini``)
against the JAX package's, on the CPU.

Each case writes one seeded capture (under ``tmp_path``) or sends it over
127.0.0.1, reads it back through both packages, and holds the samples or
fields equal exactly: LabSat 2 / 3 at 2 and 4 bits (word-unaligned reads,
an LS3 file sequence), SPIR int1 and GSS6450, the raw antenna array, the
native 2-bit / NSR readers (and the native decoders against their numpy
plain versions), UDP and rtl_tcp, the mock RF driver behind a UHD conf,
and the reference's XML ephemeris and Gnss_Synchro readers. The native
library builds into ``build/native``; a failed build raises.
"""

import socket
import struct
import threading

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.config import registry as jreg
from gnss_sdr_tpu.io import ref_xml as jxml
from gnss_sdr_tpu.io import rf_driver as jrf
from gnss_sdr_tpu.io import sources as jsrc
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.config import registry as treg
from gnss_sdr_tpu_torch.io import native as tnative
from gnss_sdr_tpu_torch.io import ref_xml as txml
from gnss_sdr_tpu_torch.io import rf_driver as trf
from gnss_sdr_tpu_torch.io import sources as tsrc
from torch_twin import assert_same

torch.set_num_threads(1)   # one thread per xdist worker

UNALIGNED = (100, 156, 1, 7, 200, 48, 333, 4096)


def _both(pairs: dict):
    jc, tc = jini.InMemoryConfiguration(), tini.InMemoryConfiguration()
    for k, v in pairs.items():
        jc.set_property(k, v)
        tc.set_property(k, v)
    return jc, tc


def _read_all(src, sizes=UNALIGNED):
    out = [src.read(n) for n in sizes]
    return np.concatenate(out, axis=-1)


def _noise(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


# ------------------------------------------------------------------ LabSat
@pytest.mark.parametrize("version,bits", [(3, 2), (3, 4), (2, 2), (2, 4)])
def test_labsat_matches_jax(tmp_path, version, bits):
    per = 8 if bits == 2 else 4
    x = _noise(600 * per, version * 10 + bits)
    words = tsrc.encode_labsat_words(x, bits)
    if version == 3:
        base = str(tmp_path / "capture")
        half = len(words) // 2          # an LS3 sequence of two files
        with open(f"{base}_0000.LS3", "wb") as f:
            f.write(tsrc.labsat_header(bits, 3))
            words[:half].astype("<u2").tofile(f)
        words[half:].astype("<u2").tofile(f"{base}_0001.LS3")
    else:
        base = str(tmp_path / "capture.ls2")
        with open(base, "wb") as f:
            f.write(tsrc.labsat_header(bits, 2))
            words.astype("<u2").tofile(f)
    jc, tc = _both({"SignalSource.implementation": "Labsat_Signal_Source",
                    "SignalSource.filename": base,
                    "SignalSource.sampling_frequency": 16_368_000})
    js, ts = jini.source_from_ini(jc), tini.source_from_ini(tc)
    assert (ts.version, ts.bits_per_sample, ts.fs) == \
        (js.version, js.bits_per_sample, js.fs) == (version, bits, 16.368e6)
    got, want = _read_all(ts), _read_all(js)
    assert len(got) == len(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tnative.decode_labsat_words_numpy(
        words, bits))
    if bits == 2:
        np.testing.assert_array_equal(np.sign(got.real), np.sign(x.real))
    assert len(ts.read(64)) == 0
    ts.close()
    js.close()


def test_labsat_header_errors_match_jax(tmp_path):
    for name, head in (("bad", b"\x01" * 64),
                       ("dual", bytearray(tsrc.labsat_header(2)))):
        if name == "dual":
            head[24] = 0
        path = tmp_path / f"{name}_0000.LS3"
        path.write_bytes(bytes(head))
        with pytest.raises(ValueError) as je:
            jsrc.LabsatSignalSource(str(tmp_path / name))
        with pytest.raises(ValueError) as te:
            tsrc.LabsatSignalSource(str(tmp_path / name))
        assert str(te.value) == str(je.value)


# -------------------------------------------------------------------- SPIR
@pytest.mark.parametrize("impl,extra", [
    ("Spir_File_Signal_Source", {"SignalSource.sel_ch": 1}),
    ("Spir_File_Signal_Source", {"SignalSource.sel_ch": 2}),
    ("Spir_GSS6450_File_Signal_Source", {"SignalSource.adc_bits": 2}),
    ("Spir_GSS6450_File_Signal_Source", {"SignalSource.adc_bits": 4})])
def test_spir_matches_jax(tmp_path, impl, extra):
    words = np.random.default_rng(11).integers(0, 1 << 32, 800,
                                               dtype=np.uint64)
    path = tmp_path / "spir.dat"
    words.astype("<u4").tofile(path)
    jc, tc = _both({"SignalSource.implementation": impl,
                    "SignalSource.filename": str(path),
                    "SignalSource.sampling_frequency": 80_000_000, **extra})
    js, ts = jini.source_from_ini(jc), tini.source_from_ini(tc)
    assert ts.total_samples == js.total_samples
    np.testing.assert_array_equal(_read_all(ts), _read_all(js))
    raw = words.astype(np.uint32).astype(np.int32)
    if "GSS" in impl:
        bits = extra["SignalSource.adc_bits"]
        np.testing.assert_array_equal(tsrc.decode_spir_gss6450(raw, bits),
                                      jsrc.decode_spir_gss6450(raw, bits))
    else:
        ch = extra["SignalSource.sel_ch"]
        np.testing.assert_array_equal(tsrc.decode_spir_int1(raw, ch),
                                      jsrc.decode_spir_int1(raw, ch))


# --------------------------------------------------------------- raw array
@pytest.mark.parametrize("item_type", ["gr_complex", "ishort"])
def test_raw_array_matches_jax(tmp_path, item_type):
    n_el, n = 4, 3000
    arr = _noise(n_el * n, 4).reshape(n_el, n) * 100
    path = tmp_path / "array.dat"
    inter = arr.T.reshape(-1)                     # element-interleaved
    if item_type == "ishort":
        raw = np.empty(2 * len(inter), np.int16)
        raw[0::2], raw[1::2] = inter.real, inter.imag
        raw.tofile(path)
    else:
        inter.tofile(path)
    jc, tc = _both({"SignalSource.implementation": "Raw_Array_Signal_Source",
                    "SignalSource.filename": str(path),
                    "SignalSource.RF_channels": n_el,
                    "SignalSource.item_type": item_type,
                    "SignalSource.sampling_frequency": 4_000_000})
    js, ts = jini.source_from_ini(jc), tini.source_from_ini(tc)
    got, want = _read_all(ts, (1000, 17, 2000)), _read_all(js, (1000, 17, 2000))
    assert got.shape == want.shape == (n_el, n)
    np.testing.assert_array_equal(got, want)
    assert ts.read(10).shape == (n_el, 0)


# ------------------------------------------------------------------ native
def test_native_decoders_match_numpy():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 16, 4096).astype(np.uint16)
    for bits in (2, 4):
        np.testing.assert_array_equal(
            tnative.decode_labsat_words(words, bits),
            tnative.decode_labsat_words_numpy(words, bits))
    raw = rng.integers(0, 256, 4096).astype(np.uint8)
    np.testing.assert_array_equal(tnative.decode_2bit_cpx(raw),
                                  tnative.decode_2bit_cpx_numpy(raw))
    assert tnative.library_path().parent == tnative.BUILD_DIR


@pytest.mark.parametrize("item_type,dtype", [("ishort", np.int16),
                                             ("ibyte", np.int8),
                                             ("short", np.int16),
                                             ("gr_complex", np.complex64)])
def test_native_reader_matches_decoders(tmp_path, item_type, dtype):
    rng = np.random.default_rng(5)
    raw = (rng.integers(-100, 100, 6000).astype(dtype)
           if dtype != np.complex64 else _noise(3000, 5))
    path = tmp_path / "cap.bin"
    raw.tofile(path)
    src = tnative.NativeFileSource(path, item_type, 4e6)
    got = _read_all(src, (700, 10_000))
    want = jsrc.decode_samples(raw, item_type)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tsrc.decode_samples(raw, item_type))
    src.seek(40)
    np.testing.assert_array_equal(src.read(10), want[40:50])
    src.close()


@pytest.mark.parametrize("impl,extra,plain", [
    ("Nsr_File_Signal_Source", {}, "real"),
    ("Two_Bit_Cpx_File_Signal_Source", {}, "cpx"),
    ("Two_Bit_Packed_File_Signal_Source", {"SignalSource.sample_type": "iq"},
     "cpx"),
    ("Two_Bit_Packed_File_Signal_Source", {}, "real")])
def test_two_bit_sources_match_jax(tmp_path, impl, extra, plain):
    raw = np.random.default_rng(8).integers(0, 256, 3000).astype(np.uint8)
    path = tmp_path / "packed.bin"
    raw.tofile(path)
    jc, tc = _both({"SignalSource.implementation": impl,
                    "SignalSource.filename": str(path),
                    "SignalSource.sampling_frequency": 4_000_000, **extra})
    js, ts = jini.source_from_ini(jc), tini.source_from_ini(tc)
    assert ts.item_type == js.item_type
    # the JAX reader overruns its buffer on counts that fill no whole byte,
    # so it reads whole bytes; the port reads any count
    got = _read_all(ts, (1001, 333, 7, 20_000))
    np.testing.assert_array_equal(got, _read_all(js, (1000, 332, 20_000)))
    want = (tnative.decode_2bit_real_numpy(raw) if plain == "real"
            else tnative.decode_2bit_cpx_numpy(raw))
    np.testing.assert_array_equal(got, want)
    ts.seek(5)
    np.testing.assert_array_equal(ts.read(9), want[5:14])
    ts.close()
    js.close()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fall back to numpy: a source that does not compile
    raises with the compiler's message."""
    bad = tmp_path / "sampleio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="native sampleio build failed"):
        tnative.decode_2bit_cpx(np.zeros(4, np.uint8))
    assert not list((tmp_path / "native").glob("*.so"))


# ----------------------------------------------------------- network: UDP
def test_udp_matches_jax():
    data = np.arange(-200, 200, dtype=np.int16)       # 200 complex samples
    got = {}
    for tag, mod in (("jax", jsrc), ("port", tsrc)):
        src = mod.UdpSignalSource(host="127.0.0.1", port=0,
                                  item_type="ishort", sampling_frequency=2e6,
                                  timeout_s=1.0)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for part in np.split(data, 4):
            tx.sendto(part.tobytes(), ("127.0.0.1", src.port))
        got[tag] = np.concatenate([src.read(30), src.read(170)])
        tx.close()
        src.close()
    np.testing.assert_array_equal(got["port"], got["jax"])
    assert got["port"][0] == -200 - 199j and len(got["port"]) == 200


# ------------------------------------------------------- network: rtl_tcp
def _rtl_server(payload: bytes, seen: dict):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"RTL0" + bytes(8))
        cmds = b""
        while len(cmds) < 15:
            part = conn.recv(15 - len(cmds))
            if not part:
                break
            cmds += part
        seen["cmds"] = [struct.unpack(">BI", cmds[i:i + 5])
                        for i in range(0, 15, 5)]
        conn.sendall(payload)
        conn.close()
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv.getsockname()[1], t


def test_rtltcp_matches_jax():
    payload = np.random.default_rng(2).integers(0, 256, 4000).astype(
        np.uint8).tobytes()
    got = {}
    for tag, ini in (("jax", jini), ("port", tini)):
        seen = {}
        port, t = _rtl_server(payload, seen)
        conf = ini.InMemoryConfiguration()
        for k, v in {"SignalSource.implementation": "RtlTcp_Signal_Source",
                     "SignalSource.address": "127.0.0.1",
                     "SignalSource.port": port,
                     "SignalSource.sampling_frequency": 2_000_000,
                     "SignalSource.freq": 1_575_420_000}.items():
            conf.set_property(k, v)
        src = ini.source_from_ini(conf)
        got[tag] = (np.concatenate([src.read(700), src.read(1300)]),
                    sorted(seen.get("cmds", [])))
        t.join(timeout=5)
        got[tag] = (got[tag][0], sorted(seen["cmds"]))
        src.close()
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1] == sorted(
        [(2, 2_000_000), (1, 1_575_420_000), (8, 1)])
    assert len(got["port"][0]) == 2000


# ------------------------------------------------------- mock RF front end
def _uhd(extra: dict):
    return _both({"SignalSource.implementation": "UHD_Signal_Source",
                  "SignalSource.sampling_frequency": 4_000_000,
                  "SignalSource.freq": 1_575_420_000,
                  "SignalSource.gain": 50, "SignalSource.antenna": "TX/RX",
                  "SignalSource.subdevice": "A:0", **extra})


def test_mock_rf_driver_matches_jax(tmp_path):
    jc, tc = _uhd({"SignalSource.driver": "mock"})
    js, ts = jini.source_from_ini(jc), tini.source_from_ini(tc)
    assert ts.fs == js.fs == 4e6
    assert_same(js.cfg, ts.cfg, "RfConfig")
    np.testing.assert_array_equal(_read_all(ts), _read_all(js))
    assert ts.driver.samples_delivered == js.driver.samples_delivered
    ts.close()
    assert not ts.driver.started
    cap = tmp_path / "play.cfile"
    _noise(5000, 6).tofile(cap)
    jc, tc = _uhd({"SignalSource.driver": "mock",
                   "SignalSource.mock_capture": str(cap)})
    js, ts = jini.source_from_ini(jc), tini.source_from_ini(tc)
    got = _read_all(ts, (1000, 3000, 2000))
    np.testing.assert_array_equal(got, _read_all(js, (1000, 3000, 2000)))
    assert len(got) == 5000
    # the conf passes the registry with the mock driver
    cfg = tini.receiver_config_from_ini(tc)


def test_mock_rf_driver_refusals_match_jax():
    for mod in (jrf, trf):
        d = mod.MockRfDriver()
        with pytest.raises(ValueError, match="tuner range"):
            d.configure(mod.RfConfig(center_freq_hz=100.0))
        with pytest.raises(RuntimeError, match="configure"):
            d.start()
        with pytest.raises(RuntimeError, match="start"):
            d.read(10)
        with pytest.raises(ImportError, match="UHD python driver"):
            mod.make_driver("uhd")
        with pytest.raises(ValueError, match="unknown RF driver"):
            mod.make_driver("nope")
    # a driver whose vendor library is missing fails as in JAX: the
    # source with the loader's ImportError, the binding with
    # UnknownBlockError, the same messages
    jc, tc = _uhd({"SignalSource.driver": "uhd"})
    with pytest.raises(ImportError) as je:
        jini.source_from_ini(jc)
    with pytest.raises(ImportError) as te:
        tini.source_from_ini(tc)
    assert str(te.value) == str(je.value)
    with pytest.raises(jreg.UnknownBlockError) as je:
        jini.receiver_config_from_ini(jc)
    with pytest.raises(treg.UnknownBlockError) as te:
        tini.receiver_config_from_ini(tc)
    assert str(te.value) == str(je.value)


# -------------------------------------------------------- reference XML
EPH_XML = """<?xml version="1.0" encoding="UTF-8" standalone="yes" ?>
<boost_serialization signature="serialization::archive" version="14">
<GNSS-SDR_ephemeris_map class_id="0" tracking_level="0" version="0">
<count>2</count><item_version>0</item_version>
{items}
</GNSS-SDR_ephemeris_map></boost_serialization>"""
EPH_ITEM = """<item><first>{prn}</first><second>
<i_satellite_PRN>{prn}</i_satellite_PRN><i_GPS_week>{week}</i_GPS_week>
<d_Toc>518400</d_Toc><d_A_f0>{af0}</d_A_f0><d_A_f1>-1.2e-11</d_A_f1>
<d_A_f2>0</d_A_f2><d_TGD>-1.1e-08</d_TGD><d_Toe>518400</d_Toe>
<d_sqrt_A>5153.6{prn}</d_sqrt_A><d_e_eccentricity>0.0123</d_e_eccentricity>
<d_M_0>1.23</d_M_0><d_Delta_n>4.9e-09</d_Delta_n><d_OMEGA0>-2.7</d_OMEGA0>
<d_OMEGA_DOT>-8.1e-09</d_OMEGA_DOT><d_OMEGA>0.93</d_OMEGA><d_i_0>0.958</d_i_0>
<d_IDOT>2.2e-10</d_IDOT><d_Cuc>1.2e-06</d_Cuc><d_Cus>7.6e-06</d_Cus>
<d_Crc>221.3</d_Crc><d_Crs>-11.6</d_Crs><d_Cic>-6.3e-08</d_Cic>
<d_Cis>1.1e-07</d_Cis><d_IODE_SF2>46</d_IODE_SF2><d_IODC>46</d_IODC>
<i_SV_health>0</i_SV_health><i_SV_accuracy>2</i_SV_accuracy>
</second></item>"""
SYNCHRO_XML = """<?xml version="1.0" encoding="UTF-8" standalone="yes" ?>
<boost_serialization signature="serialization::archive" version="14">
<GNSS-SDR_gnss_synchro_map class_id="0" tracking_level="0" version="0">
<count>3</count><item_version>0</item_version>
{items}
</GNSS-SDR_gnss_synchro_map></boost_serialization>"""
SYNCHRO_ITEM = """<item><first>{ch}</first><second>
<System>{sys}</System><Signal><count>3</count><item>{s0}</item>
<item>{s1}</item><item>0</item></Signal><PRN>{prn}</PRN>
<Channel_ID>{ch}</Channel_ID><Pseudorange_m>{pr}</Pseudorange_m>
<RX_time>518400.07</RX_time><Carrier_Doppler_hz>-1234.5</Carrier_Doppler_hz>
<Carrier_phase_rads>12.75</Carrier_phase_rads><CN0_dB_hz>44.1</CN0_dB_hz>
<TOW_at_current_symbol_ms>518400000</TOW_at_current_symbol_ms>
<Flag_valid_pseudorange>{valid}</Flag_valid_pseudorange><fs>4000000</fs>
</second></item>"""


def test_ref_xml_matches_jax(tmp_path):
    eph = tmp_path / "eph.xml"
    eph.write_text(EPH_XML.format(items="".join(
        EPH_ITEM.format(prn=p, week=2047, af0=f"{p}e-5") for p in (1, 7))))
    got = txml.load_gps_ephemeris_xml(str(eph))
    assert_same(jxml.load_gps_ephemeris_xml(str(eph)), got, "ephemerides")
    assert sorted(got) == [("G", 1), ("G", 7)]
    syn = tmp_path / "synchro.xml"
    syn.write_text(SYNCHRO_XML.format(items="".join(
        SYNCHRO_ITEM.format(ch=ch, sys=ord(sy), s0=ord(sig[0]),
                            s1=ord(sig[1]), prn=p, pr=2.1e7 + 1e5 * ch,
                            valid=v)
        for ch, (sy, sig, p, v) in enumerate((("G", "1C", 1, 1),
                                              ("E", "1B", 11, 1),
                                              ("G", "1C", 7, 0))))))
    synchros = txml.load_gnss_synchro_map_xml(str(syn))
    jsyn = jxml.load_gnss_synchro_map_xml(str(syn))
    assert_same(jsyn, synchros, "synchros")
    assert [s.signal for s in synchros] == ["1C", "1B", "1C"]
    obs = txml.synchro_to_obs_inputs(synchros)
    assert_same(jxml.synchro_to_obs_inputs(jsyn), obs, "obs inputs")
    assert [o.prn for o in obs] == [1, 11]
    with pytest.raises(ValueError, match="no <GNSS-SDR_ephemeris_map>"):
        txml.load_gps_ephemeris_xml(str(syn))
