"""The port's RTCM 3 codec, base-station ingest and NTRIP client
(gnss_sdr_tpu_torch.receiver.pvt.rtcm / rtk_engine.RtcmBaseStation /
io.ntrip) against the JAX package's, on the CPU.

Every message type the JAX codec encodes (1005 / 1006, the GPS, QZSS,
Galileo F/NAV and I/NAV, BeiDou and GLONASS ephemerides, MSM1-7 of GPS,
GLONASS, Galileo and BeiDou, the legacy 1002 / 1004 / 1012 observables, SSR
orbit, clock, combined and code bias for GPS, GLONASS and Galileo) is
encoded by both packages from the same inputs: the frames must be equal
byte for byte, and each package decodes the other's frame to the same
fields, bit for bit. The stream deframer, the time-scale conversions, the
SSR appliers and the base station's state are held the same way; the
NTRIP client runs against a caster thread on 127.0.0.1 (port 0) with
timeouts of seconds (tests/torch_twin.py's Caster), every thread joined and
every socket closed.
"""

import socket
import time

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.models.nav.glonass_gnav import GlonassEphemeris
from gnss_sdr_tpu.receiver.pvt import rtcm as jrtcm
from gnss_sdr_tpu_torch.receiver.pvt import rtcm as trtcm
from test_lnav import sample_ephemeris
from torch_twin import TAGS, Caster, assert_same, modules, twin

torch.set_num_threads(1)   # one thread per xdist worker

RTCM = {"jax": jrtcm, "port": trtcm}


def _ephemeris(prn=7, toc=352800.0, **kw):
    e = sample_ephemeris()
    e.prn, e.toc, e.toe = prn, toc, toc
    for k, v in kw.items():
        setattr(e, k, v)
    return e


def _glonass_ephemeris():
    return GlonassEphemeris(
        slot=9, freq_slot=-2, tb_s=40500.0,
        pos_m=(-12_345_678.9, 8_765_432.1, -20_123_456.7),
        vel_m_s=(-1234.5678, 2345.6789, -345.4321),
        acc_m_s2=(-1.86e-6, 9.3e-7, 2.79e-6),
        gamma_n=-3.2e-11, tau_n=-6.5e-5, health=0)


def _msm_obs(system="G"):
    obs = [
        jrtcm.MsmObservation(prn=7, signal_id=2, pseudorange_m=21_936_123.45,
                             phase_range_m=21_936_124.12,
                             phase_rate_m_s=531.25, cn0_dbhz=44.0,
                             lock_time_s=120.0),
        jrtcm.MsmObservation(prn=7, signal_id=15,
                             pseudorange_m=21_936_125.01,
                             phase_range_m=21_936_124.88,
                             phase_rate_m_s=531.10, cn0_dbhz=39.0,
                             lock_time_s=15.0),
        jrtcm.MsmObservation(prn=23, signal_id=2, pseudorange_m=24_112_874.2,
                             phase_range_m=24_112_873.9,
                             phase_rate_m_s=-712.4, cn0_dbhz=47.5,
                             lock_time_s=3.0)]
    if system == "R":                 # FDMA channels in the extended info
        obs[0].freq_slot = obs[1].freq_slot = -4
        obs[2].freq_slot = 6
    return obs


def _legacy_obs():
    return [jrtcm.LegacyObservation(
                prn=5, pseudorange_m=22_123_456.78,
                phase_range_m=22_123_457.01, lock_time_s=90.0,
                cn0_dbhz=46.5, pseudorange_l2_m=22_123_458.11,
                phase_range_l2_m=22_123_457.5, cn0_l2_dbhz=41.0),
            jrtcm.LegacyObservation(
                prn=19, pseudorange_m=20_456_789.12,
                phase_range_m=20_456_788.9, lock_time_s=500.0,
                cn0_dbhz=50.0)]


def _ssr_orbits(system):
    return [jrtcm.SsrOrbitCorrection(prn=7, iode=33 if system != "E" else 600,
                                     radial_m=1.2345, along_m=-0.5678,
                                     cross_m=0.0912, dot_radial_m_s=0.0005,
                                     dot_along_m_s=-0.0012, system=system),
            jrtcm.SsrOrbitCorrection(prn=21, iode=101, radial_m=-2.01,
                                     along_m=1.5, cross_m=-0.75,
                                     system=system)]


def _ssr_clocks(system):
    return [jrtcm.SsrClockCorrection(prn=7, c0_m=0.8421, c1_m_s=0.0031,
                                     system=system),
            jrtcm.SsrClockCorrection(prn=21, c0_m=-1.204, system=system)]


def _ssr_biases(system):
    return [jrtcm.SsrCodeBias(prn=7, biases={0: 1.23, 14: -0.87},
                              system=system),
            jrtcm.SsrCodeBias(prn=19, biases={1: -2.45}, system=system)]


_TOW = {"G": 345_600.0, "R": 40_000.0, "E": 345_600.0}
_ECEF = np.array([4027893.1234, 307045.9876, 4919475.0001])

# name -> (encoder name, its arguments built with JAX classes, decoder
# name[, keyword arguments])
CODEC_CASES = {
    "1005": ("encode_1005", lambda: (42, _ECEF), "decode_1005"),
    "1006": ("encode_1006", lambda: (901, _ECEF, 1.3456), "decode_1006",
             dict(glo=True)),
    "1019": ("encode_1019", lambda: (_ephemeris(),), "decode_1019"),
    "1020": ("encode_1020", lambda: (_glonass_ephemeris(),), "decode_1020"),
    "1042": ("encode_1042", lambda: (_ephemeris(tgd=4.7e-9),),
             "decode_1042"),
    "1044": ("encode_1044", lambda: (_ephemeris(prn=195),), "decode_1044"),
    "1045": ("encode_1045", lambda: (_ephemeris(prn=11, ura=107),),
             "decode_1045"),
    "1046": ("encode_1046",
             lambda: (_ephemeris(prn=11, week=1234, iode=87, tgd=-4.7e-9,
                                 toc=345600.0), -5.1e-9, 1, 2),
             "decode_1046"),
    **{f"msm{msg}": ("encode_msm",
                     lambda msg=msg: (msg, 902, 345_600_123,
                                      _msm_obs(jrtcm.MSM_MESSAGES[msg][1])),
                     "decode_msm")
       for msg in sorted(jrtcm.MSM_MESSAGES)},
    "1002": ("encode_1002", lambda: (77, 123_456_000, _legacy_obs()),
             "decode_legacy_obs"),
    "1004": ("encode_1004", lambda: (77, 123_456_000, _legacy_obs()),
             "decode_legacy_obs"),
    "1012": ("encode_1012",
             lambda: (14, 43_200_123, [jrtcm.LegacyObservation(
                 prn=3, pseudorange_m=19_876_543.21,
                 phase_range_m=19_876_543.05, lock_time_s=33.0,
                 cn0_dbhz=43.25, freq_slot=-4)]),
             "decode_legacy_obs"),
    **{f"ssr_orbit_{s}": ("encode_ssr_orbit",
                          lambda s=s: (_TOW[s], _ssr_orbits(s), 3, s),
                          "decode_ssr_orbit") for s in "GRE"},
    **{f"ssr_clock_{s}": ("encode_ssr_clock",
                          lambda s=s: (_TOW[s], _ssr_clocks(s), 3, s),
                          "decode_ssr_clock") for s in "GRE"},
    **{f"ssr_combined_{s}": ("encode_ssr_combined",
                             lambda s=s: (_TOW[s], _ssr_orbits(s),
                                          _ssr_clocks(s), 5, s),
                             "decode_ssr_combined") for s in "GRE"},
    **{f"ssr_code_bias_{s}": ("encode_ssr_code_bias",
                              lambda s=s: (_TOW[s], _ssr_biases(s), 5, s),
                              "decode_ssr_code_bias") for s in "GRE"},
}


def _encode(name: str, tag: str) -> np.ndarray:
    enc, args, _, *kw = CODEC_CASES[name]
    return getattr(RTCM[tag], enc)(*twin(args(), tag),
                                   **(kw[0] if kw else {}))


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_codec_frames_and_cross_decode_equal_jax(name):
    """Both packages' frames of one message are equal byte for byte; each
    package deframes and decodes the other's frame to the same fields."""
    bits = {tag: _encode(name, tag) for tag in TAGS}
    frames = {tag: RTCM[tag].frame(bits[tag]) for tag in TAGS}
    assert frames["port"] == frames["jax"]
    assert trtcm.message_number(bits["port"]) == jrtcm.message_number(
        bits["jax"])
    dec = CODEC_CASES[name][2]
    jax_reads_port = getattr(jrtcm, dec)(jrtcm.deframe(frames["port"])[0])
    port_reads_jax = getattr(trtcm, dec)(trtcm.deframe(frames["jax"])[0])
    assert_same(jax_reads_port, port_reads_jax, name)


def test_codec_reads_what_it_wrote():
    """The port's decoders give back what was encoded, within each field's
    quantization (tests/test_rtcm.py's round-trip bounds)."""
    eph = twin(_ephemeris(), "port")
    dec = trtcm.decode_1019(trtcm.encode_1019(eph))
    assert (dec.prn, dec.iode, dec.toe) == (eph.prn, eph.iode, eph.toe)
    assert abs(dec.sqrt_a - eph.sqrt_a) <= 2.0 ** -19
    gal = trtcm.decode_1045(trtcm.encode_1045(twin(_ephemeris(prn=11),
                                                   "port")))
    assert gal.prn == 11 and abs(gal.af0 - eph.af0) <= 2.0 ** -34
    obs = twin(_msm_obs("R"), "port")
    hdr, back = trtcm.decode_msm(trtcm.encode_msm(trtcm.MSM7_GLO, 9,
                                                  208_800_000, obs))
    assert hdr["epoch_ms"] == 208_800_000
    assert hdr["raw_epoch"] == trtcm.gps_tow_ms_to_glonass_epoch(208_800_000)
    for o, d in zip(sorted(obs, key=lambda o: (o.prn, o.signal_id)),
                    sorted(back, key=lambda o: (o.prn, o.signal_id))):
        assert (d.prn, d.signal_id, d.freq_slot) == (o.prn, o.signal_id,
                                                     o.freq_slot)
        assert abs(d.pseudorange_m - o.pseudorange_m) < 1e-3
        assert abs(d.phase_range_m - o.phase_range_m) < 3e-4
    hdr, back = trtcm.decode_msm(trtcm.encode_msm(trtcm.MSM7_BDS, 5,
                                                  345_600_123, obs))
    assert hdr["raw_epoch"] == 345_600_123 - trtcm.BDT_GPS_OFFSET_MS


def _stream() -> bytes:
    """Every codec case's frame, with garbage between two of them."""
    frames = [jrtcm.frame(_encode(name, "jax")) for name in CODEC_CASES]
    return (b"\x00garbage" + b"".join(frames[:5]) + b"\xd3\x00trail"
            + b"".join(frames[5:]))


@pytest.mark.parametrize("piece", [1, 7, 37, 4096])
def test_deframe_stream_over_split_streams(piece):
    """deframe_stream fed in pieces of ``piece`` bytes returns the same
    payloads and remainders as JAX's, and every frame comes out once; a
    corrupted byte fails the CRC in both."""
    data = _stream()
    got = {}
    for tag in TAGS:
        buf, payloads, rests = b"", [], []
        for i in range(0, len(data), piece):
            out, buf = RTCM[tag].deframe_stream(buf + data[i:i + piece])
            payloads += out
            rests.append(buf)
        got[tag] = (payloads, rests)
    assert_same(got["jax"], got["port"])
    assert len(got["port"][0]) == len(CODEC_CASES)
    bad = bytearray(trtcm.frame(_encode("1005", "port")))
    bad[7] ^= 0x40
    assert trtcm.deframe(bytes(bad)) == jrtcm.deframe(bytes(bad)) == []


def test_time_scales_and_lock_indicator_equal_jax():
    """GPS TOW <-> GLONASS day-of-week / time-of-day over the week and
    across day boundaries, the GLONASS time-of-day to GPS second-of-day
    map, and the DF013 lock-time indicator and its inverse."""
    tows = np.concatenate([np.arange(0, 7 * 86_400_000, 3_599_917),
                           [208_800_000, 167_400_000, 604_799_999,
                            (86400 + 22 * 3600 + 1800) * 1000]])
    got = {}
    for tag in TAGS:
        r = RTCM[tag]
        epochs = [r.gps_tow_ms_to_glonass_epoch(int(t)) for t in tows]
        got[tag] = dict(
            epochs=epochs,
            back=[r.glonass_epoch_to_gps_tow_ms(e) for e in epochs],
            sod=[r.glonass_tod_ms_to_gps_sod_ms(int(t) % 86_400_000)
                 for t in tows],
            lock=[r._lock_indicator(s) for s in range(0, 2000, 3)],
            secs=[r._lock_seconds(i) for i in range(128)],
            resolved=[r.resolve_modulo_range(pr % r.RANGE_MS, pr + d)
                      for pr in (2.1e7, 2.31e7) for d in (-9e4, 0, 9e4)])
    assert_same(got["jax"], got["port"])
    assert got["port"]["back"] == [int(t) for t in tows]


def test_ssr_appliers_equal_jax():
    """apply_ssr_orbit / clock / code_bias on seeded states."""
    rng = np.random.default_rng(3)
    states = [(rng.normal(0, 1.5e7, 3), rng.normal(0, 2e3, 3))
              for _ in range(8)]
    orb = _ssr_orbits("G")[0]
    clk = _ssr_clocks("G")[0]
    bias = _ssr_biases("G")[0]
    got = {}
    for tag in TAGS:
        r = RTCM[tag]
        o, c, b = twin((orb, clk, bias), tag)
        got[tag] = dict(
            orbit=[r.apply_ssr_orbit(p, v, o) for p, v in states],
            clock=[r.apply_ssr_clock(1.2e-4, c, dt_s=dt)
                   for dt in (0.0, 10.0, -3.5)],
            bias=[r.apply_ssr_code_bias(2e7, b, sid) for sid in (0, 14, 7)])
    assert_same(got["jax"], got["port"])
    assert got["port"]["bias"][2] == 2e7        # unknown signal: unchanged


def _base_state(bs) -> dict:
    return dict(base_ecef=bs.base_ecef, height=bs.antenna_height_m,
                ephemerides=bs.ephemerides, ssr_orbit=bs.ssr_orbit,
                ssr_clock=bs.ssr_clock, ssr_code_bias=bs.ssr_code_bias,
                epochs=bs.epochs)


def test_base_station_ingest_equals_jax():
    """RtcmBaseStation fed every message type in awkward pieces holds the
    same base position, ephemerides keyed (system, prn), SSR maps and
    epochs (MSM1-3 partial observations dropped, legacy 1012 on an
    unresolved day) as JAX's; epoch matching gives the same answers."""
    data = _stream()
    got = {}
    for tag in TAGS:
        bs = modules(tag, e="receiver.pvt.rtk_engine").e.RtcmBaseStation(
            max_epochs=64)
        for i in range(0, len(data), 17):
            bs.push_bytes(data[i:i + 17])
        got[tag] = dict(_base_state(bs),
                        near=[bs.epoch_near_tagged(t) for t in (
                            345_600.123, 123_456.0, 123_456.2,
                            4 * 86400 + 43_200.123 - 10_800 + 18,
                            1e6)])
    assert_same(got["jax"], got["port"])
    port = got["port"]
    assert port["height"] == pytest.approx(1.3456, abs=1e-4)
    assert {("G", 7), ("R", 9), ("C", 7), ("E", 11)} <= set(
        port["ephemerides"])
    assert {("G", 7), ("R", 7), ("E", 7)} <= set(port["ssr_orbit"])
    assert ("E", 19) in port["ssr_code_bias"]
    # MSM4-7 of four systems, 1002 / 1004 / 1012: MSM1-3 dropped
    assert len(port["epochs"]) == 4 * 4 + 3
    assert [d for *_, d in port["epochs"]].count(False) == 1
    assert port["near"][0] is not None and port["near"][-1] is None


def test_ntrip_client_streams_into_the_base_station():
    """NtripClient negotiates a mountpoint with Basic credentials (the
    request bytes equal JAX's) and streams the caster's bytes into the
    port's RtcmBaseStation."""
    from gnss_sdr_tpu.io.ntrip import NtripClient as JClient
    from gnss_sdr_tpu_torch.io.ntrip import NtripClient
    from gnss_sdr_tpu_torch.receiver.pvt.rtk_engine import RtcmBaseStation

    assert (NtripClient("h", 1, "BASE1", "user", "pw")._request()
            == JClient("h", 1, "BASE1", "user", "pw")._request())
    caster = Caster(mount="BASE1", payload=trtcm.frame(trtcm.encode_1005(
        42, np.array([4e6, 1e5, 4.8e6]))))
    bs = RtcmBaseStation()
    cli = NtripClient("127.0.0.1", caster.port, "BASE1", username="user",
                      password="pw")
    try:
        cli.stream_to(bs.push_bytes)
        deadline = time.time() + 5.0
        while bs.base_ecef is None and time.time() < deadline:
            time.sleep(0.02)
    finally:
        cli.close()
        caster.close()
    np.testing.assert_allclose(bs.base_ecef, [4e6, 1e5, 4.8e6], atol=1e-3)
    req = caster.requests[0].decode()
    assert req.startswith("GET /BASE1 HTTP/1.0")
    assert "Authorization: Basic dXNlcjpwdw==" in req


def test_ntrip_client_rejects_a_bad_mountpoint():
    """A caster answering with its sourcetable raises NtripError, as in
    JAX."""
    from gnss_sdr_tpu_torch.io.ntrip import NtripClient, NtripError

    caster = Caster(mount="BASE1")
    cli = NtripClient("127.0.0.1", caster.port, "NOPE")
    try:
        with pytest.raises(NtripError, match="NOPE"):
            cli.connect(timeout_s=5.0)
    finally:
        cli.close()
        caster.close()
    assert caster.requests[0].startswith(b"GET /NOPE ")


def test_rtcm_server_broadcasts_frames():
    """RtcmServer sends each message framed to a connected client."""
    srv = trtcm.RtcmServer()
    cli = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
    try:
        deadline = time.time() + 5.0
        while not srv._clients and time.time() < deadline:
            time.sleep(0.01)
        bits = trtcm.encode_1005(7, np.array([1.0e6, 2.0e6, 3.0e6]))
        srv.send(bits)
        cli.settimeout(5.0)
        data = cli.recv(4096)
    finally:
        cli.close()
        srv.close()
    assert data == jrtcm.frame(jrtcm.encode_1005(7, np.array(
        [1.0e6, 2.0e6, 3.0e6])))
