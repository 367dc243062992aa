"""Real-time UDP monitoring sinks; a copy of gnss_sdr_tpu/io/monitor.py.

Reference analogs: ``gnss_synchro_monitor`` + ``Gnss_Synchro_Udp_Sink``
(``src/core/monitor/``) and ``Monitor_Pvt_Udp_Sink``
(``src/algorithms/PVT/libs/monitor_pvt_udp_sink.cc``). Two serializations:
JSON lines (zero dependencies, trivially consumable) and the reference's
protobuf wire format (``monitor_pb2``, a copy of the JAX package's module
generated from gnss_sdr_tpu/data/monitor.proto — field numbers/types match
docs/protobuf/gnss_synchro.proto + monitor_pvt.proto, so reference-side
listeners such as gnss-sdr-monitor parse these datagrams unchanged).
"""

from __future__ import annotations

import dataclasses
import json
import socket


class UdpSink:
    def __init__(self, addresses: list[tuple[str, int]]):
        self.addresses = addresses
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, payload: dict) -> None:
        data = (json.dumps(payload) + "\n").encode()
        for addr in self.addresses:
            try:
                self._sock.sendto(data, addr)
            except OSError:
                pass

    def close(self) -> None:
        self._sock.close()


class GnssSynchroMonitor:
    """Streams per-channel observables every Nth epoch (decimation)."""

    def __init__(self, addresses: list[tuple[str, int]], decimation: int = 1):
        self.sink = UdpSink(addresses)
        self.decimation = max(1, decimation)
        self._count = 0

    def push(self, tick_sample: int, observables: list) -> None:
        self._count += 1
        if self._count % self.decimation:
            return
        self.sink.send({
            "type": "gnss_synchro",
            "sample_counter": tick_sample,
            "channels": [dataclasses.asdict(o) for o in observables],
        })


class _RawUdpSink(UdpSink):
    def send_bytes(self, data: bytes) -> None:
        for addr in self.addresses:
            try:
                self._sock.sendto(data, addr)
            except OSError:
                pass


def _pb2():
    """The generated protobuf module, imported on first use: JSON stays the
    default and needs no package."""
    try:
        from gnss_sdr_tpu_torch.io import monitor_pb2
    except ImportError as e:
        raise ImportError(
            "Monitor.enable_protobuf / PVT.enable_protobuf need the "
            "google.protobuf package (pip name: protobuf), which is not "
            f"installed: {e}") from e
    return monitor_pb2


class ProtobufGnssSynchroMonitor:
    """Observables monitor in the reference's protobuf wire format: one
    ``Observables`` message (repeated GnssSynchro) per epoch datagram."""

    def __init__(self, addresses: list[tuple[str, int]], decimation: int = 1,
                 fs: float = 0.0):
        _pb2()                      # fail at set-up without protobuf
        self.sink = _RawUdpSink(addresses)
        self.decimation = max(1, decimation)
        self.fs = fs
        self._count = 0

    def push(self, tick_sample: int, observables: list) -> None:
        self._count += 1
        if self._count % self.decimation:
            return
        from gnss_sdr_tpu_torch import constants
        msg = _pb2().Observables()
        for i, o in enumerate(observables):
            s = msg.observable.add()
            s.system = constants.SIGNALS[o.signal].system
            s.signal = o.signal
            s.prn = o.prn
            s.channel_id = i
            s.fs = int(self.fs)
            s.cn0_db_hz = o.cn0_dbhz
            s.carrier_doppler_hz = o.doppler_hz
            s.carrier_phase_rads = o.carrier_phase_cycles * 6.283185307179586
            s.tracking_sample_counter = int(tick_sample)
            s.flag_valid_symbol_output = True
            s.flag_valid_word = True
            s.pseudorange_m = o.pseudorange_m
            s.rx_time = o.t_tx_sv + o.pseudorange_m / 299_792_458.0
            s.flag_valid_pseudorange = True
            s.interp_tow_ms = o.t_tx_sv * 1e3
        self.sink.send_bytes(msg.SerializeToString())


class ProtobufPvtMonitor:
    """PVT monitor in the reference's MonitorPvt protobuf wire format."""

    def __init__(self, addresses: list[tuple[str, int]]):
        _pb2()                      # fail at set-up without protobuf
        self.sink = _RawUdpSink(addresses)

    def push(self, sol) -> None:
        if not sol.valid:
            return
        m = _pb2().MonitorPvt()
        m.tow_at_current_symbol_ms = int(sol.tow_s * 1e3)
        m.week = int(sol.week)
        m.rx_time = float(sol.tow_s)
        m.user_clk_offset = float(sol.clock_bias_s)
        m.pos_x, m.pos_y, m.pos_z = map(float, sol.pos_ecef)
        m.vel_x, m.vel_y, m.vel_z = map(float, sol.vel_ecef)
        m.latitude = float(sol.lat_rad) * 57.29577951308232
        m.longitude = float(sol.lon_rad) * 57.29577951308232
        m.height = float(sol.height_m)
        m.valid_sats = int(sol.n_sats)
        m.solution_status = 0
        m.solution_type = 0
        m.gdop, m.pdop = float(sol.gdop), float(sol.pdop)
        m.hdop, m.vdop = float(sol.hdop), float(sol.vdop)
        self.sink.send_bytes(m.SerializeToString())


class PvtMonitor:
    def __init__(self, addresses: list[tuple[str, int]]):
        self.sink = UdpSink(addresses)

    def push(self, sol) -> None:
        if not sol.valid:
            return
        self.sink.send({
            "type": "monitor_pvt",
            "tow_s": sol.tow_s,
            "week": sol.week,
            "pos_ecef": list(map(float, sol.pos_ecef)),
            "vel_ecef": list(map(float, sol.vel_ecef)),
            "lat_deg": float(sol.lat_rad) * 57.29577951308232,
            "lon_deg": float(sol.lon_rad) * 57.29577951308232,
            "height_m": float(sol.height_m),
            "clock_bias_s": sol.clock_bias_s,
            "clock_drift_s_s": sol.clock_drift_s_s,
            "n_sats": sol.n_sats,
            "gdop": sol.gdop, "pdop": sol.pdop,
            "hdop": sol.hdop, "vdop": sol.vdop,
        })
