"""The port's output products (gnss_sdr_tpu_torch.receiver.outputs and the
pvt writers it wires) against the JAX package's, on the CPU.

Both packages' ``attach_outputs`` hang their writers on a CPU receiver of
their own; the same hand-built fixes and observables (and equal
ephemerides) go through the sinks, and every product must come out byte
for byte the same: NMEA, KML / GPX / GeoJSON, RINEX 3.02 and 2.11
observation and navigation files, the RTCM 3 stream read from each
``RtcmServer`` over localhost, and the JSON monitor datagrams. The RINEX
headers' creation date is the wall clock: it is frozen to one instant in
both modules (no line is masked). The RTCM encoders are also held against
JAX's frame for frame, and the decoders and the RINEX readers read back
what was written.
"""

import dataclasses
import datetime
import socket
import sys
import time
import types

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.models.ephemeris import IonoParams as JIono
from gnss_sdr_tpu.models.ephemeris import KeplerEphemeris as JEph
from gnss_sdr_tpu.models.ephemeris import UtcParams as JUtc
from gnss_sdr_tpu.receiver import outputs as jout
from gnss_sdr_tpu.receiver import receiver as jrx
from gnss_sdr_tpu.receiver.pvt import rinex as jrinex
from gnss_sdr_tpu.receiver.pvt import rtcm as jrtcm
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, UtcParams
from gnss_sdr_tpu_torch.receiver import outputs as tout
from gnss_sdr_tpu_torch.receiver import receiver as trx
from gnss_sdr_tpu_torch.receiver.observables import ChannelObservable
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.receiver.pvt import rinex as trinex
from gnss_sdr_tpu_torch.receiver.pvt import rtcm as trtcm
from gnss_sdr_tpu_torch.receiver.pvt.solver import PvtSolution
from gnss_sdr_tpu_torch.utils import constellation

torch.set_num_threads(1)   # one thread per xdist worker

PRNS = (3, 8, 11, 19, 24, 30)
WEEK, TOW0 = 2290, 352810.5


class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 6, 7, 8, 9, tzinfo=tz)


@pytest.fixture
def frozen_clock(monkeypatch):
    fake = types.SimpleNamespace(datetime=_Frozen, date=datetime.date,
                                 timezone=datetime.timezone,
                                 timedelta=datetime.timedelta)
    monkeypatch.setattr(jrinex, "datetime", fake)
    monkeypatch.setattr(trinex, "datetime", fake)


def _ephemerides():
    """Equal GPS ephemerides in each package's class."""
    ephs = constellation.almanac_constellation(week=WEEK)
    port = {}
    for k, prn in enumerate(PRNS):
        e = ephs[prn]
        e.iode, e.iodc, e.ura = 17 + k, 300 + k, 2
        e.af0, e.af1, e.tgd = 1.5e-5 * (k - 2), -2.3e-12, -1.1e-8
        port[("G", prn)] = e
    jax = {key: JEph(**dataclasses.asdict(e)) for key, e in port.items()}
    return port, jax


def _fixes():
    out = []
    for k in range(4):
        lat, lon = np.deg2rad(41.275 + 1e-6 * k), np.deg2rad(1.9876 - 2e-6 * k)
        h = 80.0 + 0.3 * k
        out.append(PvtSolution(
            valid=True, pos_ecef=geodesy.geodetic_to_ecef(lat, lon, h),
            vel_ecef=np.array([0.01 * k, -0.02, 0.005]),
            clock_bias_s=1.2e-4 + 1e-9 * k, clock_drift_s_s=3e-8,
            tow_s=TOW0 + 0.1 * k, week=WEEK, n_sats=6, gdop=2.1 + 0.01 * k,
            pdop=1.9, hdop=1.1, vdop=1.5, lat_rad=lat, lon_rad=lon,
            height_m=h))
    return out


def _observables(k: int):
    rng = np.random.default_rng(100 + k)
    return [ChannelObservable(
        prn=prn, signal="1C", t_tx_sv=TOW0 + 0.1 * k - 0.072 - 1e-3 * i,
        pseudorange_m=2.1e7 + 3.1e5 * i + rng.uniform(0, 10),
        carrier_phase_cycles=1.1e8 + 1.7e6 * i + rng.uniform(0, 1),
        doppler_hz=rng.uniform(-4000, 4000),
        cn0_dbhz=rng.uniform(40, 50)) for i, prn in enumerate(PRNS)]


def _conf(tmp, tag, udp_port):
    return (f"PVT.nmea_dump_filename={tmp}/{tag}.nmea\n"
            f"PVT.kml_filename={tmp}/{tag}.kml\n"
            f"PVT.gpx_filename={tmp}/{tag}.gpx\n"
            f"PVT.geojson_filename={tmp}/{tag}.geojson\n"
            f"PVT.rinex_obs_filename={tmp}/{tag}.obs\n"
            f"PVT.rinex_nav_filename={tmp}/{tag}.nav\n"
            "PVT.flag_rtcm_server=true\nPVT.rtcm_tcp_port=0\n"
            "PVT.rtcm_MT1019_rate_ms=200\n"
            "PVT.enable_monitor=true\n"
            "PVT.monitor_client_addresses=127.0.0.1\n"
            f"PVT.monitor_udp_port={udp_port}\n"
            "Monitor.enable_monitor=true\n"
            "Monitor.client_addresses=127.0.0.1\n"
            f"Monitor.udp_port={udp_port}\n")


def _drive(rx, ephs, out, fixes):
    """Give the receiver tracking channels, ephemerides and fixes, and push
    observables / fixes through its sinks; returns the RTCM bytes a
    localhost client read."""
    g = rx.groups[0]
    for ch, prn in zip(g.channels, PRNS):
        ch.prn, ch.state = prn, "tracking"
        ch.push_record_block([10], [5], [0.1], [1.023e6], [1500.0], [7],
                             [0.25], [44.0 + prn / 10])
    rx.ephemerides.update(ephs)
    cli = socket.create_connection(("127.0.0.1", out.rtcm_server.port),
                                   timeout=5)
    deadline = time.time() + 5.0        # the server accepts on its thread
    while not out.rtcm_server._clients and time.time() < deadline:
        time.sleep(0.01)
    for k, sol in enumerate(fixes):
        rx.fixes.append(sol)
        obs = _observables(k)
        for sink in rx.obs_sinks:
            sink(1000 * k, obs)
        for sink in rx.fix_sinks:
            sink(sol)
    out.close()
    data = b""
    while chunk := cli.recv(65536):
        data += chunk
    cli.close()
    return data


def _udp():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(2.0)
    return s


def _datagrams(s) -> list:
    out = []
    try:
        while True:
            out.append(s.recv(65536))
    except socket.timeout:
        return out


def test_attach_outputs_byte_identical(tmp_path, frozen_clock):
    tephs, jephs = _ephemerides()
    fixes = _fixes()
    got = {}
    for tag, ini, mod, rxmod, ephs in (
            ("jax", jini, jout, jrx, jephs), ("port", tini, tout, trx, tephs)):
        udp = _udp()
        conf = ini.InMemoryConfiguration(ini._parse(
            _conf(tmp_path, tag, udp.getsockname()[1])))
        cfg = rxmod.ReceiverConfig(fs=2e6, n_channels=8, prns=PRNS)
        rx = (rxmod.Receiver(cfg) if rxmod is jrx
              else rxmod.Receiver(cfg, device="cpu"))
        out = mod.attach_outputs(rx, conf)
        got[tag] = dict(rtcm=_drive(rx, ephs, out, fixes),
                        udp=_datagrams(udp))
        udp.close()
        for ext in ("nmea", "kml", "gpx", "geojson", "obs", "nav"):
            got[tag][ext] = (tmp_path / f"{tag}.{ext}").read_bytes()
    for key, want in got["jax"].items():
        assert got["port"][key] == want, key
    assert got["port"]["nmea"].count(b"$GPGGA") == 4
    assert len(got["port"]["udp"]) == 8            # 4 epochs + 4 fixes
    frames = trtcm.deframe(got["port"]["rtcm"])
    # ephemerides go out with the 1st fix and every 2nd (200 ms / 100 ms)
    assert [trtcm.message_number(f) for f in frames].count(1019) == 3 * 6
    assert {trtcm.message_number(f) for f in frames} == {1005, 1019, 1077}
    nav = trinex.RinexNavReader(tmp_path / "port.nav").read()
    assert sorted(nav) == sorted(tephs)
    for key, e in nav.items():
        assert e.sqrt_a == pytest.approx(tephs[key].sqrt_a, rel=1e-12)
        assert (e.iode, e.toe) == (tephs[key].iode, tephs[key].toe)
    epochs = trinex.RinexObsReader(tmp_path / "port.obs").read_epochs()
    assert len(epochs) == 4 and {o["prn"] for o in epochs[0][1]} == set(PRNS)


@pytest.mark.parametrize("version", ["3.02", "2.11"])
def test_rinex_writers_byte_identical(tmp_path, frozen_clock, version):
    tephs, jephs = _ephemerides()
    iono = dict(alpha=(1.1e-8, 2e-8, -6e-8, -1.2e-7),
                beta=(9.0e4, 4.9e4, -1.9e5, -2.6e5), valid=True)
    utc = dict(a0=-9.3e-10, a1=-8.9e-15, tot=405504, wnt=WEEK % 256,
               delta_t_ls=18, valid=True)
    for tag, mod, ephs, Iono, Utc in (
            ("jax", jrinex, jephs, JIono, JUtc),
            ("port", trinex, tephs, IonoParams, UtcParams)):
        obs = mod.RinexObsWriter(tmp_path / f"{tag}.obs", ["1C"],
                                 approx_pos=(4.8e6, 1.6e5, 4.1e6),
                                 version=version)
        for k in range(3):
            obs.write_epoch(WEEK, TOW0 + 0.1 * k, _observables(k))
        obs.close()
        nav = mod.RinexNavWriter(tmp_path / f"{tag}.nav", version=version,
                                 iono=Iono(**iono), utc=Utc(**utc))
        for e in ephs.values():
            nav.write_ephemeris(e, system="G")
        nav.close()
    for ext in ("obs", "nav"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    # a Kepler record named GLONASS is refused as JAX refuses it (GLONASS
    # writes GlonassEphemeris geph records); SBAS GEO records are not ported
    for mod, e in ((trinex, next(iter(tephs.values()))),
                   (jrinex, next(iter(jephs.values())))):
        with pytest.raises(ValueError, match="GlonassEphemeris"):
            mod.RinexNavWriter(tmp_path / "r.nav").write_ephemeris(
                e, system="R")
    with pytest.raises(NotImplementedError, match="SBAS"):
        trinex.RinexNavWriter(tmp_path / "s.nav").write_ephemeris(
            types.SimpleNamespace(agf0_s=0.0, prn=120), system="S")


def test_rtcm_encoders_match_jax():
    tephs, jephs = _ephemerides()
    pos = geodesy.geodetic_to_ecef(np.deg2rad(41.275), np.deg2rad(1.9876),
                                   80.0)
    pairs = [(trtcm.encode_1005(1234, pos), jrtcm.encode_1005(1234, pos))]
    pairs += [(trtcm.encode_1019(tephs[k]), jrtcm.encode_1019(jephs[k]))
              for k in tephs]
    obs = [trtcm.MsmObservation(prn=o.prn, signal_id=2,
                                pseudorange_m=o.pseudorange_m,
                                phase_range_m=o.carrier_phase_cycles * 0.19,
                                phase_rate_m_s=-o.doppler_hz * 0.19,
                                cn0_dbhz=o.cn0_dbhz, lock_time_s=3.0)
           for o in _observables(0)]
    jobs = [jrtcm.MsmObservation(**dataclasses.asdict(o)) for o in obs]
    for msg in range(1071, 1078):
        pairs.append((trtcm.encode_msm(msg, 7, 352810500, obs),
                      jrtcm.encode_msm(msg, 7, 352810500, jobs)))
    for t, j in pairs:
        assert trtcm.frame(t) == jrtcm.frame(j)
    head, back = trtcm.decode_msm7(pairs[-1][0])
    assert head["epoch_ms"] == 352810500 and len(back) == len(obs)
    e = trtcm.decode_1019(pairs[1][0])
    assert (e.prn, e.iode) == (tephs[("G", PRNS[0])].prn,
                               tephs[("G", PRNS[0])].iode)
    np.testing.assert_allclose(trtcm.decode_1005(pairs[0][0])["ecef"], pos,
                               atol=1e-4)
    for bad in (lambda: trtcm.encode_1045(tephs[("G", 3)]),
                lambda: trtcm.encode_msm(1087, 7, 0, obs),
                lambda: trtcm.encode_msm(1097, 7, 0, obs)):
        with pytest.raises(NotImplementedError):
            bad()


def test_protobuf_monitor_needs_its_package(monkeypatch):
    from gnss_sdr_tpu_torch.io import monitor

    monkeypatch.setitem(sys.modules, "gnss_sdr_tpu_torch.io.monitor_pb2",
                        None)
    with pytest.raises(ImportError, match="google.protobuf"):
        monitor.ProtobufPvtMonitor([("127.0.0.1", 9)])
    with pytest.raises(ImportError, match="google.protobuf"):
        monitor.ProtobufGnssSynchroMonitor([("127.0.0.1", 9)])


def test_unported_outputs_name_their_keys():
    for text, key in (("PVT.rtk_base_address=127.0.0.1\n",
                       "PVT.rtk_base_address"),
                      ("PVT.positioning_mode=PPP_Static\n",
                       "PVT.positioning_mode=PPP_Static")):
        rx = trx.Receiver(trx.ReceiverConfig(fs=2e6), device="cpu")
        with pytest.raises(NotImplementedError, match=key):
            tout.attach_outputs(rx, tini.InMemoryConfiguration(
                tini._parse(text)))
