"""The port's SUPL A-GNSS stack (gnss_sdr_tpu_torch.io.uper / io.supl) and
its wiring into the receiver against the JAX package's, on the CPU.

The port's modules are copies of the JAX package's host code, so every case
runs both packages on the same inputs and holds the results equal exactly:
the UPER codec's bytes, the ULP / RRLP round trips, the assistance each
client collects from each package's QA server over 127.0.0.1 (port 0), the
``Assistance`` records (``tests/torch_twin.py``'s ``assert_same``: floats
bit for bit), ``fetch_supl_assistance`` from INI keys, and the predicted
Dopplers ``apply_assistance`` drives. Nothing leaves the machine.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.io import supl as jsupl
from gnss_sdr_tpu.io import uper as juper
from gnss_sdr_tpu.models.almanac import GpsAlmanac
from gnss_sdr_tpu.models.ephemeris import IonoParams, KeplerEphemeris, UtcParams
from gnss_sdr_tpu_torch.io import supl as tsupl
from gnss_sdr_tpu_torch.io import uper as tuper
from torch_twin import assert_same, twin

torch.set_num_threads(1)   # one thread per xdist worker

PKGS = {"jax": (juper, jsupl), "port": (tuper, tsupl)}


def _eph(prn=13):
    return KeplerEphemeris(
        prn=prn, toc=345600.0, af0=4.2e-4, af1=-1.8e-11, af2=0.0,
        tgd=-5.2e-9, toe=345600.0, sqrt_a=5153.71, e=0.0123,
        m0=1.21, delta_n=4.9e-9, omega0=-2.71, omega_dot=-8.1e-9,
        omega=0.93, i0=0.958, idot=2.2e-10, cuc=1.2e-6, cus=7.6e-6,
        crc=221.3, crs=-11.6, cic=-6.3e-8, cis=1.1e-7,
        iode=46, iodc=46, health=0, ura=2)


ALM = GpsAlmanac(prn=5, e=0.004, toa=319488.0, delta_i=0.02,
                 omega_dot=-7.9e-9, sqrt_a=5153.6, omega0=1.1, omega=-0.5,
                 m0=2.2, af0=3.1e-5, af1=3.6e-12, health=0, wna=77)
IONO = IonoParams(alpha=(1.2e-8, -7.5e-9, -6.0e-8, 1.2e-7),
                  beta=(96256.0, -32768.0, -196608.0, 65536.0), valid=True)
UTC = UtcParams(a0=9.3e-9, a1=-2.7e-15, tot=405504.0, wnt=2240 % 256,
                delta_t_ls=18, valid=True)


def _server_kwargs(tag: str) -> dict:
    """The same QA server contents, built with ``tag``'s classes."""
    return twin(dict(ephemerides=[_eph(p) for p in (2, 5, 13, 21, 29)],
                     almanacs=[ALM], wna=77, iono=IONO, utc=UTC,
                     ref_llh=(41.275, 1.9876, 80.0), gps_week=2240,
                     gps_tow=345600.0,
                     acq_assist=[(2, 1250.0, 431.0), (13, -2210.0, 17.0)]),
                tag)


# ------------------------------------------------------------- UPER engine
def _uper_cases(u):
    return [
        *[(u.INT(lo, hi), v) for lo, hi, v in (
            (0, 7, 5), (0, 255, 200), (1, 1, 1), (-2048, 2047, -1),
            (0, 65535, 65535), (-2147483648, 2147483647, -123456789))],
        (u.SEQ(u.F("a", u.INT(0, 15)), u.F("b", u.INT(0, 15))),
         {"a": 0xA, "b": 0x5}),
        (u.SEQ(u.F("a", u.INT(0, 7), optional=True)), {}),
        (u.SEQ(u.F("a", u.INT(0, 255)), ext=True), {"a": 7}),
    ]


def test_uper_known_vectors_equal_bytes():
    want = [juper.encode(s, v) for s, v in _uper_cases(juper)]
    got = [tuper.encode(s, v) for s, v in _uper_cases(tuper)]
    assert got == want
    assert got[6] == b"\xa5" and got[7] == b"\x00"
    for (s, v), raw in zip(_uper_cases(tuper), got):
        assert tuper.decode(s, raw) == v
    fq = "supl.example-1.com"
    raw = tuper.encode(tsupl.FQDN, fq)
    assert raw == juper.encode(jsupl.FQDN, fq)
    assert tuper.decode(tsupl.FQDN, raw) == fq


def test_uper_extension_skip():
    out = {}
    for tag, (u, _s) in PKGS.items():
        w = u.BitW()
        for v, n in ((1, 1), (7, 8), (0, 7), (1, 1), (2, 8), (0xBEEF, 16)):
            w.bits(v, n)
        out[tag] = u.decode(u.SEQ(u.F("a", u.INT(0, 255)), ext=True),
                            w.tobytes())
    assert out["port"] == out["jax"] == {"a": 7, "_ext": [b"\xbe\xef"]}


# ----------------------------------------------------------- ULP / RRLP
@pytest.mark.parametrize("message", [
    ("msSUPLSTART", {"sETCapabilities": jsupl._CAPABILITIES,
                     "locationId": {"cellInfo": ("gsmCell", {
                         "refMCC": 244, "refMNC": 5, "refLAC": 0x59E2,
                         "refCI": 0x31B0}), "status": "current"},
                     "qoP": {"horacc": 0}}),
    ("msSUPLRESPONSE", {"posMethod": "agpsSETbased"}),
    ("msSUPLEND", {"statusCode": "posMethodFailure"})],
    ids=lambda m: m[0])
def test_ulp_round_trip_equal_bytes(message):
    sid = {"setSessionID": {"sessionId": 7,
                            "setId": ("msisdn", jsupl._MSISDN)}}
    raw = tsupl.encode_ulp(sid, message)
    assert raw == jsupl.encode_ulp(sid, message)
    assert int.from_bytes(raw[:2], "big") == len(raw)
    pdu = tsupl.decode_ulp(raw)
    assert pdu == jsupl.decode_ulp(raw)
    assert pdu["message"][0] == message[0]
    assert pdu["sessionID"]["setSessionID"]["sessionId"] == 7


def _rrlp_eph_pdu(s, eph):
    return {"referenceNumber": 3, "component": ("assistanceData", {
        "gps-AssistData": {"controlHeader": {"navigationModel": {
            "navModelList": [{"satelliteID": eph.prn - 1,
                              "satStatus": ("newSatelliteAndModelUC",
                                            s.eph_to_rrlp(eph))}]}}}})}


def test_rrlp_ephemeris_round_trip():
    out = {}
    for tag, (u, s) in PKGS.items():
        eph = twin(_eph(), tag)
        raw = u.encode(s.RRLP_PDU, _rrlp_eph_pdu(s, eph))
        assist = s.SuplAssist()
        assert s.collect_rrlp(assist, u.decode(s.RRLP_PDU, raw)) is False
        [(prn, ue)] = assist.ephemerides
        out[tag] = (raw, s.eph_from_rrlp(prn, ue))
    assert out["port"][0] == out["jax"][0]
    assert_same(out["jax"][1], out["port"][1], "eph_from_rrlp")
    back = out["port"][1]
    assert back.prn == 13 and back.iodc == 46 and back.toe == 345600.0
    assert abs(back.sqrt_a - 5153.71) <= 2.0 ** -19


def test_rrlp_almanac_iono_utc_reftime_refloc():
    out = {}
    for tag, (u, s) in PKGS.items():
        kw = _server_kwargs(tag)
        kw.pop("ephemerides")
        hdrs = s.SuplServer(**kw)._control_headers({
            "almanacRequested": True, "ionosphericModelRequested": True,
            "utcModelRequested": True, "referenceTimeRequested": True,
            "referenceLocationRequested": True,
            "acquisitionAssistanceRequested": True})
        assist = s.SuplAssist()
        raws = []
        for hdr in hdrs:
            raws.append(u.encode(s.RRLP_PDU, {
                "referenceNumber": 0, "component": (
                    "assistanceData",
                    {"gps-AssistData": {"controlHeader": hdr}})}))
            s.collect_rrlp(assist, u.decode(s.RRLP_PDU, raws[-1]))
        out[tag] = (raws, s.to_assistance(assist))
    assert out["port"][0] == out["jax"][0]
    assert_same(out["jax"][1], out["port"][1], "assistance")
    a = out["port"][1]
    assert a.almanacs[("G", 5)].wna == 77 and a.utc.delta_t_ls == 18
    assert a.tow_s == pytest.approx(345600.0, abs=0.08)
    assert a.acq[("G", 13)]["doppler_hz"] == pytest.approx(-2210.0, abs=2.5)


# --------------------------------------------------------- full sessions
def _session(server_tag: str, client_tag: str, request: int):
    srv = PKGS[server_tag][1].SuplServer(n_batches=3,
                                         **_server_kwargs(server_tag))
    srv.start()
    s = PKGS[client_tag][1]
    assist = s.SuplClient("127.0.0.1", srv.port,
                          timeout_s=10.0).get_assist(request)
    srv.join(timeout=10)
    assert not srv.is_alive()
    if srv.error:
        raise srv.error
    return srv, assist, s.to_assistance(assist)


@pytest.mark.parametrize("request_kind", [0, 1, 2],
                         ids=["almanac", "ephemeris", "acquisition"])
def test_clients_and_servers_cross(request_kind):
    """The port's client against the JAX server and the JAX client against
    the port's server collect what JAX's client collects from JAX's."""
    _, ref_raw, ref = _session("jax", "jax", request_kind)
    for server, client in (("jax", "port"), ("port", "jax")):
        srv, raw, got = _session(server, client, request_kind)
        assert srv.got_posinit is not None and srv.got_start is not None
        if request_kind == 1:
            assert srv.n_acks >= 1          # the paging loop ran
        assert_same(ref_raw, raw, f"{client} client, {server} server")
        assert_same(ref, got, f"assistance, {client} client")


def _fetch(tag: str):
    u, s = PKGS[tag]
    srv = s.SuplServer(n_batches=2, n_sessions=3, **_server_kwargs(tag))
    srv.start()
    ini = __import__(("gnss_sdr_tpu" if tag == "jax" else
                      "gnss_sdr_tpu_torch") + ".config.ini",
                     fromlist=["ini"])
    conf = ini.InMemoryConfiguration({
        "GNSS-SDR.SUPL_gps_enabled": "true",
        "GNSS-SDR.SUPL_gps_ephemeris_server": "127.0.0.1",
        "GNSS-SDR.SUPL_gps_ephemeris_port": str(srv.port),
        "GNSS-SDR.SUPL_LAC": "0x59e2", "GNSS-SDR.SUPL_CI": "0x31b0"})
    a = s.fetch_supl_assistance(conf)
    srv.join(timeout=30)
    assert not srv.is_alive()
    if srv.error:
        raise srv.error
    return a, ini


def test_fetch_supl_assistance_from_ini():
    want, _ = _fetch("jax")
    got, tini = _fetch("port")
    assert_same(want, got, "fetch_supl_assistance")
    assert sorted(p for _s, p in got.ephemerides) == [2, 5, 13, 21, 29]
    assert got.iono.valid and got.position_ecef is not None
    assert got.acq[("G", 2)]["code_phase_chips"] == 431.0
    assert tsupl.fetch_supl_assistance(tini.InMemoryConfiguration({})) \
        is None


def test_apply_assistance_drives_predicted_dopplers():
    """SUPL's ephemerides, reference position / time and acquisition hints
    set the assisted search's Doppler centres as in the JAX receiver."""
    from gnss_sdr_tpu.receiver.receiver import Receiver as JRx
    from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JCfg
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver as TRx
    from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig as TCfg

    want_a, _ = _fetch("jax")
    got_a, _ = _fetch("port")
    kw = dict(signal="1C", fs=2.0e6, n_channels=2, prns=(2, 5, 13),
              acq_assisted=True)
    jrx, trx = JRx(JCfg(**kw)), TRx(TCfg(**kw), device="cpu")
    jrx.apply_assistance(want_a)
    trx.apply_assistance(got_a)
    assert trx.assist_tow == jrx.assist_tow
    np.testing.assert_array_equal(trx.assist_pos, jrx.assist_pos)
    for cands in ([2, 13], [2, 5, 13], [5]):
        want = jrx._predicted_dopplers(jrx.groups[0], cands)
        got = trx._predicted_dopplers(trx.groups[0], cands)
        assert want is not None and got == want, cands
    # the acquisition hint wins over the ephemeris prediction
    assert trx._predicted_dopplers(trx.groups[0], [2])[0] == \
        pytest.approx(1250.0, abs=2.5)
    # stale hints (> 10 min of receiver time) fall back to the ephemeris
    trx.acq_assist[("G", 2)]["tow_s"] -= 1000.0
    jrx.acq_assist[("G", 2)]["tow_s"] -= 1000.0
    assert trx._predicted_dopplers(trx.groups[0], [2]) == \
        jrx._predicted_dopplers(jrx.groups[0], [2])
