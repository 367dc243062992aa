"""Wire PVT/observables output products onto a Receiver from configuration.

Port of gnss_sdr_tpu/receiver/outputs.py. Reference analog: the output half of ``rtklib_pvt_gs`` — per config it
instantiates RINEX/NMEA/KML/GPX/GeoJSON printers, the RTCM TCP server and
the UDP monitors, and feeds them each epoch (rtklib_pvt_gs.cc work()).
Here the same products hang off ``Receiver.fix_sinks`` / ``obs_sinks``.

Config keys honored (reference names where they exist):
  PVT.nmea_dump_filename        NMEA-0183 sentences file
  PVT.kml_filename / gpx_filename / geojson_filename   track files
  PVT.rinex_obs_filename / rinex_nav_filename          RINEX writers
  PVT.flag_rtcm_server=true + PVT.rtcm_tcp_port        RTCM 3 TCP server
  PVT.rtcm_station_id, PVT.rtcm_MSM_rate_ms, PVT.rtcm_MT1019_rate_ms
  Monitor.enable_monitor=true + Monitor.client_addresses + Monitor.udp_port
  PVT.enable_monitor=true + PVT.monitor_client_addresses + PVT.monitor_udp_port

Not ported yet (``NotImplementedError`` naming the key): the RTK rover
(PVT.rtk_base_address) and the PPP modes (PVT.positioning_mode=PPP_*).
"""

from __future__ import annotations

import logging

from gnss_sdr_tpu_torch import constants

log = logging.getLogger("gnss_sdr_tpu_torch")

# MSM signal-slot ids per constellation (RTCM tables 3.5-91/-100):
_MSM_SIGNAL_ID = {"1C": 2, "2S": 15, "L5": 22, "1B": 2, "5X": 22,
                  "B1": 2, "B3": 8, "1G": 2, "2G": 8}


class OutputSet:
    """Holds every attached output product; close() flushes files."""

    def __init__(self):
        self.closers: list = []

    def close(self) -> None:
        for c in self.closers:
            try:
                c()
            except Exception:                    # pragma: no cover
                log.exception("output close failed")


def attach_outputs(rx, conf) -> OutputSet:
    out = OutputSet()
    prop = conf.property

    nmea_path = prop("PVT.nmea_dump_filename", "")
    if nmea_path:
        from gnss_sdr_tpu_torch.receiver.pvt.nmea import NmeaPrinter
        nmea = NmeaPrinter(nmea_path)

        def _cn0_by_prn():
            return {ch.prn: rec.cn0_dbhz
                    for g in rx.groups for ch in g.channels
                    if ch.state == "tracking"
                    and (rec := ch.last_record()) is not None}

        rx.fix_sinks.append(lambda s, _p=nmea: _p.push(
            s, rx.tracked_prns(), ephemerides=rx.ephemerides,
            cn0_by_prn=_cn0_by_prn()))
        out.closers.append(nmea.close)

    for key, cls_name in (("PVT.kml_filename", "KmlPrinter"),
                          ("PVT.gpx_filename", "GpxPrinter"),
                          ("PVT.geojson_filename", "GeoJsonPrinter")):
        path = prop(key, "")
        if path:
            from gnss_sdr_tpu_torch.receiver.pvt import tracks
            p = getattr(tracks, cls_name)(path)
            rx.fix_sinks.append(p.push)
            out.closers.append(p.close)

    obs_path = prop("PVT.rinex_obs_filename", "")
    if obs_path:
        from gnss_sdr_tpu_torch.receiver.pvt.rinex import RinexObsWriter
        sigs = sorted({g.signal for g in rx.groups})
        # GLONASS slot -> frequency number table for the 3.02 header
        # (same published mapping the FDMA channelizer uses)
        slots = rx.cfg.glonass_freq_slots
        glo_slots = {p: slots[(p - 1) % len(slots)]
                     for g in rx.groups if g.spec.fdma_step_hz > 0.0
                     for p in g.acq_pool}
        w = RinexObsWriter(obs_path, sigs,
                           version=str(prop("PVT.rinex_version", "3.02")),
                           glo_slots=glo_slots)

        def push_obs(tick, observables, _w=w):
            week = rx.fixes[-1].week if rx.fixes else 0
            o0 = observables[0]
            tow = o0.t_tx_sv + o0.pseudorange_m / 299_792_458.0
            _w.write_epoch(week, tow, observables)
        rx.obs_sinks.append(push_obs)
        out.closers.append(w.close)

    nav_path = prop("PVT.rinex_nav_filename", "")
    if nav_path:
        from gnss_sdr_tpu_torch.receiver.pvt.rinex import RinexNavWriter
        w = RinexNavWriter(nav_path)
        written = set()

        def push_nav(sol, _w=w):
            for key, eph in list(rx.ephemerides.items()):
                tag = (key, getattr(eph, "iode", 0))
                if tag not in written:
                    written.add(tag)
                    _w.write_ephemeris(eph, system=key[0])
        rx.fix_sinks.append(push_nav)
        out.closers.append(w.close)

    if prop("PVT.flag_rtcm_server", False):
        from gnss_sdr_tpu_torch.receiver.pvt import rtcm as rtcm_mod
        srv = rtcm_mod.RtcmServer(port=int(prop("PVT.rtcm_tcp_port", 2101)))
        station = int(prop("PVT.rtcm_station_id", 1234))
        eph_every = max(1, int(float(prop("PVT.rtcm_MT1019_rate_ms", 5000))
                               / max(rx.cfg.pvt_output_rate_ms, 1)))
        state = {"n": 0}

        def push_rtcm_fix(sol):
            state["n"] += 1
            if state["n"] == 1 or state["n"] % eph_every == 0:
                srv.send(rtcm_mod.encode_1005(station, sol.pos_ecef))
                for (sys, prn), eph in list(rx.ephemerides.items()):
                    if sys == "G":
                        srv.send(rtcm_mod.encode_1019(eph))
                    elif sys == "E":
                        srv.send(rtcm_mod.encode_1045(eph))   # raises

        def push_rtcm_obs(tick, observables):
            o0 = observables[0]
            tow = o0.t_tx_sv + o0.pseudorange_m / 299_792_458.0
            by_sys: dict[str, list] = {}
            for o in observables:
                spec = constants.SIGNALS[o.signal]
                lam = 299_792_458.0 / spec.carrier_freq_hz
                by_sys.setdefault(spec.system, []).append(
                    rtcm_mod.MsmObservation(
                        prn=o.prn,
                        signal_id=_MSM_SIGNAL_ID.get(o.signal, 2),
                        pseudorange_m=o.pseudorange_m,
                        phase_range_m=getattr(o, "carrier_phase_cycles",
                                              0.0) * lam,
                        phase_rate_m_s=-o.doppler_hz * lam,
                        cn0_dbhz=o.cn0_dbhz))
            epoch_ms = int(round(tow * 1e3))
            for sys, obs_list in by_sys.items():
                msg = {"G": rtcm_mod.MSM7_GPS}.get(sys)
                if msg and obs_list:
                    srv.send(rtcm_mod.encode_msm7(msg, station, epoch_ms,
                                                  obs_list))
        rx.fix_sinks.append(push_rtcm_fix)
        rx.obs_sinks.append(push_rtcm_obs)
        out.closers.append(srv.close)
        log.info("RTCM server on tcp/%d", srv.port)
        out.rtcm_server = srv

    base_host = prop("PVT.rtk_base_address", "")
    if base_host:
        raise NotImplementedError(
            f"PVT.rtk_base_address={base_host}: the RTK rover is not ported "
            f"yet")
    ppp_mode_key = str(prop("PVT.positioning_mode", "Single"))
    if ppp_mode_key in ("PPP_Static", "PPP_Kinematic"):
        raise NotImplementedError(
            f"PVT.positioning_mode={ppp_mode_key}: PPP is not ported yet")

    def _addr_list(addr_key, port_key, default_port):
        addrs = str(prop(addr_key, "")).strip()
        if not addrs:
            return []
        port = int(prop(port_key, default_port))
        return [(a.strip(), port) for a in addrs.split(",") if a.strip()]

    if prop("Monitor.enable_monitor", False):
        addrs = _addr_list("Monitor.client_addresses", "Monitor.udp_port", 1234)
        if addrs:
            # reference Monitor.enable_protobuf selects the protobuf wire
            # format (gnss_synchro.proto); default there is protobuf — here
            # JSON stays the default unless the key asks for protobuf
            if prop("Monitor.enable_protobuf", False):
                from gnss_sdr_tpu_torch.io.monitor import ProtobufGnssSynchroMonitor
                m = ProtobufGnssSynchroMonitor(
                    addrs,
                    decimation=int(prop("Monitor.decimation_factor", 1)),
                    fs=float(prop("GNSS-SDR.internal_fs_sps", 0)))
            else:
                from gnss_sdr_tpu_torch.io.monitor import GnssSynchroMonitor
                m = GnssSynchroMonitor(
                    addrs, decimation=int(prop("Monitor.decimation_factor", 1)))
            rx.obs_sinks.append(m.push)
            out.closers.append(m.sink.close)

    if prop("PVT.enable_monitor", False):
        addrs = _addr_list("PVT.monitor_client_addresses",
                           "PVT.monitor_udp_port", 1235)
        if addrs:
            if prop("PVT.enable_protobuf", False):
                from gnss_sdr_tpu_torch.io.monitor import ProtobufPvtMonitor
                m = ProtobufPvtMonitor(addrs)
            else:
                from gnss_sdr_tpu_torch.io.monitor import PvtMonitor
                m = PvtMonitor(addrs)
            rx.fix_sinks.append(m.push)
            out.closers.append(m.sink.close)

    return out
