"""Control plane: telecommand TCP server, event queue, assistance persistence.

Port of gnss_sdr_tpu/receiver/control.py.

Reference analogs:
  * ``TcpCmdInterface`` (src/core/receiver/tcp_cmd_interface.cc:60): line-based
    TCP telecommands status/standby/reset/hotstart/warmstart/coldstart/
    set_ch_satellite.
  * ``ControlThread`` event queue (control_thread.cc:299) — here a
    thread-safe queue the chunk loop polls between chunks.
  * assistance XML persistence (control_thread.cc:402 read_assistance_from_XML)
    — here JSON files carrying the same ephemeris/iono/UTC payload, the
    receiver's warm/hot-start checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import queue
import socket
import threading

import numpy as np

from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, KeplerEphemeris, UtcParams


@dataclasses.dataclass
class CommandEvent:
    command: str
    args: tuple = ()


class ControlQueue:
    """Thread-safe command/event queue (reference: Concurrent_Queue<pmt>)."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()

    def push(self, ev: CommandEvent) -> None:
        self._q.put(ev)

    def pop_all(self) -> list[CommandEvent]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out


class TelecommandServer:
    """Line-based TCP command interface.

    Commands (reference parity, tcp_cmd_interface.cc:62-68):
      status                  -> last PVT fix summary
      standby                 -> stop all channels
      coldstart / warmstart / hotstart -> restart acquisition (with/without
                                 persisted assistance)
      reset                   -> receiver restart (exit harness)
      set_ch_satellite CH PRN -> pin a channel to a satellite
    """

    def __init__(self, control_queue: ControlQueue, status_fn,
                 host: str = "127.0.0.1", port: int = 0):
        self.queue = control_queue
        self.status_fn = status_fn
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(2)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        self._sock.settimeout(0.3)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(2.0)
                f = conn.makefile("rw")
                for line in f:
                    reply = self._handle(line.strip())
                    try:
                        f.write(reply + "\n")
                        f.flush()
                    except OSError:
                        break
                    if line.strip() in ("exit", "quit"):
                        break

    def _handle(self, line: str) -> str:
        if not line:
            return "ERROR: empty command"
        parts = line.split()
        cmd = parts[0].lower()
        if cmd == "status":
            return self.status_fn()
        if cmd in ("standby", "reset", "coldstart", "warmstart", "hotstart"):
            self.queue.push(CommandEvent(cmd))
            return f"OK: {cmd}"
        if cmd == "set_ch_satellite" and len(parts) == 3:
            try:
                self.queue.push(CommandEvent("set_ch_satellite",
                                             (int(parts[1]), int(parts[2]))))
                return "OK: set_ch_satellite"
            except ValueError:
                return "ERROR: bad arguments"
        if cmd in ("exit", "quit"):
            return "OK: bye"
        return f"ERROR: unknown command {cmd}"

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Assistance persistence (warm/hot start checkpoint)
# ---------------------------------------------------------------------------


def _eph_key_str(key) -> str:
    """(system, prn) -> "G12"; bare int prn (legacy) -> "G<prn>"."""
    if isinstance(key, tuple):
        return f"{key[0]}{key[1]}"
    return f"G{key}"


def _eph_key_parse(s: str):
    if s[0].isalpha():
        return (s[0], int(s[1:]))
    return ("G", int(s))   # legacy bare-prn checkpoints


def save_assistance(path, ephemerides: dict,
                    iono: IonoParams | None = None,
                    utc: UtcParams | None = None,
                    almanacs: dict | None = None,
                    position_ecef=None, tow_s: float | None = None) -> None:
    """Ephemerides keyed by (system, prn) (bare int prn also accepted);
    values are KeplerEphemeris or GlonassEphemeris dataclasses, tagged with
    their class for reload (reference analog: PVT block XML serialization,
    control_thread.cc read_assistance_from_XML). Almanacs (weeks-valid),
    the last position and its receiver time persist alongside — together
    they are the classic warm-start state (reference almanac XML set,
    control_thread.h:189-202)."""
    ser = {}
    for key, e in ephemerides.items():
        d = dataclasses.asdict(e)
        d["__cls__"] = type(e).__name__
        ser[_eph_key_str(key)] = d
    alm_ser = {}
    for key, a in (almanacs or {}).items():
        d = dataclasses.asdict(a)
        d["__cls__"] = type(a).__name__
        alm_ser[_eph_key_str(key)] = d
    data = {
        "ephemerides": ser,
        "almanacs": alm_ser,
        "iono": dataclasses.asdict(iono) if iono else None,
        "utc": dataclasses.asdict(utc) if utc else None,
        "position_ecef": (list(map(float, position_ecef))
                          if position_ecef is not None else None),
        "tow_s": tow_s,
    }
    pathlib.Path(path).write_text(json.dumps(data, indent=1))


def load_assistance(path):
    """Returns an Assistance record; missing file -> empty assistance.
    Ephemerides/almanacs come back keyed by (system, prn)."""
    from gnss_sdr_tpu_torch.models.almanac import (BeidouAlmanac, GalileoAlmanac,
                                                   GlonassAlmanac, GpsAlmanac)
    from gnss_sdr_tpu_torch.models.nav.glonass_gnav import GlonassEphemeris
    p = pathlib.Path(path)
    if not p.exists():
        return Assistance()
    data = json.loads(p.read_text())
    ephs = {}
    for key, d in data.get("ephemerides", {}).items():
        cls_name = d.pop("__cls__", "KeplerEphemeris")
        if cls_name == "GlonassEphemeris":
            for f in ("pos_m", "vel_m_s", "acc_m_s2"):
                if f in d:
                    d[f] = tuple(d[f])
            eph = GlonassEphemeris(**d)
        else:
            eph = KeplerEphemeris(**d)
        ephs[_eph_key_parse(key)] = eph
    alms = {}
    for key, d in data.get("almanacs", {}).items():
        cls_name = d.pop("__cls__", "GpsAlmanac")
        cls = {"GlonassAlmanac": GlonassAlmanac,
               "GalileoAlmanac": GalileoAlmanac,
               "BeidouAlmanac": BeidouAlmanac}.get(cls_name, GpsAlmanac)
        alms[_eph_key_parse(key)] = cls(**d)
    iono = None
    if data.get("iono"):
        d = data["iono"]
        iono = IonoParams(alpha=tuple(d["alpha"]), beta=tuple(d["beta"]),
                          valid=d["valid"])
    utc = None
    if data.get("utc"):
        utc = UtcParams(**data["utc"])
    pos = data.get("position_ecef")
    return Assistance(
        ephemerides=ephs, almanacs=alms, iono=iono, utc=utc,
        position_ecef=(np.array(pos, float) if pos else None),
        tow_s=data.get("tow_s"))


@dataclasses.dataclass
class Assistance:
    """Warm/hot-start state bundle (the JSON checkpoint's contents)."""

    ephemerides: dict = dataclasses.field(default_factory=dict)
    almanacs: dict = dataclasses.field(default_factory=dict)
    iono: IonoParams | None = None
    utc: UtcParams | None = None
    position_ecef: object = None       # np.ndarray [3] or None
    tow_s: float | None = None
    # SUPL acquisition assistance: (system, prn) -> Doppler/code-phase
    # hints. Short-lived — not persisted to JSON (reference keeps it in the
    # in-memory global_gps_acq_assist_map); SUPL is not ported yet
    acq: dict = dataclasses.field(default_factory=dict)


def predicted_doppler(eph: KeplerEphemeris, rcv_ecef: np.ndarray,
                      t_gps: float, carrier_freq_hz: float) -> float:
    """Assisted-acquisition Doppler prediction from almanac/ephemeris
    (reference: pcps_assisted_acquisition / ControlThread::get_visible_sats).
    """
    from gnss_sdr_tpu_torch import constants as C
    pos, vel = eph.position_velocity(t_gps)
    los = (pos - rcv_ecef)
    los = los / np.linalg.norm(los)
    rr = float(los @ vel)
    return -rr / (C.SPEED_OF_LIGHT_M_S / carrier_freq_hz)
