"""RTK engine: consume a base-station RTCM stream, difference against the
rover's own observables, and produce fixed/float baselines.

The port's copy of gnss_sdr_tpu/receiver/pvt/rtk_engine.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: the rover side of RTKLIB inside the reference PVT
(``rtklib_rtkpos.cc`` fed by ``rtklib_rtcm3.cc`` stream input): 1005 gives
the base position, 1019/1045 broadcast ephemerides, MSM7 the base
observables; ``relpos()`` (our ``rtk.solve_rtk``) runs per matched epoch.
"""

from __future__ import annotations

import logging
import socket
import threading

import numpy as np

from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.receiver.pvt import rtcm, rtk

log = logging.getLogger("gnss_sdr_tpu_torch")

# invert the MSM signal-slot mapping used by outputs.py per system
_SIG_FROM_SLOT = {("G", 2): "1C", ("G", 15): "2S", ("G", 22): "L5",
                  ("E", 2): "1B", ("E", 22): "5X",
                  ("R", 2): "1G", ("R", 8): "2G",
                  ("C", 2): "B1", ("C", 8): "B3"}


class RtcmBaseStation:
    """Decodes a base-station RTCM byte stream into epochs/ephemerides.

    Feed bytes with :meth:`push_bytes` (or let :meth:`connect_tcp` spawn a
    reader thread). Keeps the latest base position, ephemerides keyed
    (system, prn), and a short history of MSM epochs for epoch matching.
    """

    def __init__(self, max_epochs: int = 20):
        self.base_ecef: np.ndarray | None = None
        self.antenna_height_m: float = 0.0
        self.ephemerides: dict = {}
        # SSR state (1057-1059 GPS / 1063-1065 GLONASS / 1240-1242
        # Galileo), keyed by (system, prn)
        self.ssr_orbit: dict = {}
        self.ssr_clock: dict = {}
        self.ssr_code_bias: dict = {}
        # (time_s, system, observations, day_known): time_s is GPS
        # time-of-week EXCEPT for legacy 1012 epochs, whose 27-bit field is
        # GLONASS time-of-day only — those store GPS second-of-day with
        # day_known=False and the day is resolved against the rover epoch
        # (rtklib adjday_glot role)
        self.epochs: list[tuple[float, str,
                                list[rtcm.MsmObservation], bool]] = []
        self._max_epochs = max_epochs
        self._buf = b""
        self._lock = threading.Lock()
        self._sock = None
        self._thread = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- ingest
    def push_bytes(self, data: bytes) -> None:
        with self._lock:
            payloads, self._buf = rtcm.deframe_stream(self._buf + data)
            for p in payloads:
                self._handle(p)

    def _handle(self, payload_bits: np.ndarray) -> None:
        msg = rtcm.message_number(payload_bits)
        if msg == 1005:
            d = rtcm.decode_1005(payload_bits)
            self.base_ecef = d["ecef"]
        elif msg == 1006:
            d = rtcm.decode_1006(payload_bits)
            self.base_ecef = d["ecef"]
            self.antenna_height_m = d["height_m"]
        elif msg == 1019:
            e = rtcm.decode_1019(payload_bits)
            self.ephemerides[("G", e.prn)] = e
        elif msg == 1020:
            e = rtcm.decode_1020(payload_bits)
            self.ephemerides[("R", e.slot)] = e
        elif msg == 1042:
            e = rtcm.decode_1042(payload_bits)
            self.ephemerides[("C", e.prn)] = e
        elif msg == 1044:
            e = rtcm.decode_1044(payload_bits)
            self.ephemerides[("J", e.prn)] = e
        elif msg == 1045:
            e = rtcm.decode_1045(payload_bits)
            self.ephemerides[("E", e.prn)] = e
        elif msg == 1046:
            e, _info = rtcm.decode_1046(payload_bits)
            self.ephemerides[("E", e.prn)] = e
        elif msg in (1057, 1063, 1240):
            _, corrs = rtcm.decode_ssr_orbit(payload_bits)
            for c in corrs:
                self.ssr_orbit[(c.system, c.prn)] = c
        elif msg in (1058, 1064, 1241):
            _, corrs = rtcm.decode_ssr_clock(payload_bits)
            for c in corrs:
                self.ssr_clock[(c.system, c.prn)] = c
        elif msg in (1059, 1065, 1242):
            _, biases = rtcm.decode_ssr_code_bias(payload_bits)
            for b in biases:
                self.ssr_code_bias[(b.system, b.prn)] = b
        elif msg in (1060, 1066, 1243):
            _, corrs, clks = rtcm.decode_ssr_combined(payload_bits)
            for c in corrs:
                self.ssr_orbit[(c.system, c.prn)] = c
            for c in clks:
                self.ssr_clock[(c.system, c.prn)] = c
        elif msg in rtcm.MSM_MESSAGES:
            hdr, obs = rtcm.decode_msm(payload_bits)
            _level, system = rtcm.MSM_MESSAGES[msg]
            # MSM1-3 ranges are ambiguous by k * 1 ms (no DF397) and MSM1/2
            # lack a measured phase/code; until a predicted-range resolver
            # is wired in (rtcm.resolve_modulo_range), keep only fully
            # resolved observations rather than feeding ~300 km-ambiguous
            # pseudoranges into the differential pipeline
            kept = [o for o in obs
                    if not o.modulo_1ms and o.has_phase and o.has_code]
            if len(kept) != len(obs):
                log.warning(
                    "MSM%d (%d): dropped %d/%d modulo-1ms/partial obs "
                    "(range ambiguity unresolved)", _level, msg,
                    len(obs) - len(kept), len(obs))
            if not kept:
                return
            obs = kept
            # decode_msm already reports epoch_ms as GPS TOW for all
            # systems (GLONASS dow/tod converted by the codec)
            tow = hdr["epoch_ms"] * 1e-3
            self.epochs.append((tow, system, obs, True))
            if len(self.epochs) > self._max_epochs:
                self.epochs.pop(0)
        elif msg in (1002, 1004, 1012):
            # legacy extended observables -> the same MSM-shaped epochs
            # (no phase-rate field: has_rate=False so slip detection does
            # not mistake 0 for a measured Doppler)
            hdr, legacy = rtcm.decode_legacy_obs(payload_bits)
            system = "R" if msg == 1012 else "G"
            obs = []
            for lo in legacy:
                obs.append(rtcm.MsmObservation(
                    prn=lo.prn, signal_id=2,
                    pseudorange_m=lo.pseudorange_m,
                    phase_range_m=lo.phase_range_m,
                    cn0_dbhz=lo.cn0_dbhz, lock_time_s=lo.lock_time_s,
                    has_rate=False))
                if lo.pseudorange_l2_m is not None:
                    obs.append(rtcm.MsmObservation(
                        prn=lo.prn, signal_id=15 if system == "G" else 8,
                        pseudorange_m=lo.pseudorange_l2_m,
                        phase_range_m=lo.phase_range_l2_m,
                        cn0_dbhz=lo.cn0_l2_dbhz, lock_time_s=lo.lock_time_s,
                        has_rate=False))
            if msg == 1012:
                # 1012 epoch is GLONASS time-of-day (UTC+3h): only the GPS
                # second-of-day is recoverable from the message
                t = rtcm.glonass_tod_ms_to_gps_sod_ms(hdr["epoch_ms"]) * 1e-3
                day_known = False
            else:
                t = hdr["epoch_ms"] * 1e-3
                day_known = True
            self.epochs.append((t, system, obs, day_known))
            if len(self.epochs) > self._max_epochs:
                self.epochs.pop(0)

    def epoch_near(self, tow: float, tol_s: float = 0.05
                   ) -> list[rtcm.MsmObservation] | None:
        """All MSM observations (any system) within tol of the rover epoch."""
        got = self.epoch_near_tagged(tow, tol_s)
        return got[1] if got is not None else None

    def epoch_near_tagged(self, tow: float, tol_s: float = 0.05
                          ) -> tuple[float, list] | None:
        """(base epoch tow, observations) within tol of the rover epoch.

        Epochs stored with an unknown day (legacy 1012) are matched on
        second-of-day, resolving the day from the rover TOW itself. The
        matched tow lets the solver model the base geometry at the BASE
        measurement instant — the rover tow tag runs on the rover clock
        (tens of ms off GPS time before any steering), and satellites move
        ~4 km/s across that gap (rtklib relpos computes satposs per side).
        """
        best: list[rtcm.MsmObservation] = []
        t_best = None
        for t, system, obs, day_known in self.epochs:
            if not day_known:
                # place t on the rover's day (nearest-day fold)
                t = t + round((tow - t) / 86400.0) * 86400.0
            if abs(t - tow) <= tol_s:
                best.extend(_tag(o, system) for o in obs)
                t_best = t
        return (t_best, best) if best else None

    # -------------------------------------------------------------- ntrip
    def connect_ntrip(self, host: str, port: int, mountpoint: str,
                      username: str | None = None,
                      password: str | None = None) -> None:
        """Stream the base data from an NTRIP caster mountpoint
        (reference: RTKLIB STR_NTRIPCLI, rtklib_stream.h:67-69)."""
        from gnss_sdr_tpu_torch.io.ntrip import NtripClient
        self._ntrip = NtripClient(host, port, mountpoint,
                                  username=username, password=password)
        self._ntrip.stream_to(self.push_bytes)

    # ---------------------------------------------------------------- tcp
    def connect_tcp(self, host: str, port: int, timeout_s: float = 5.0) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self) -> None:
        while not self._stop.is_set():
            try:
                data = self._sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            self.push_bytes(data)

    def close(self) -> None:
        self._stop.set()
        if getattr(self, "_ntrip", None) is not None:
            self._ntrip.close()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def _tag(o: rtcm.MsmObservation, system: str) -> rtcm.MsmObservation:
    o.system = system          # annotate (MsmObservation is a dataclass)
    return o


class RtkEngine:
    """Differences rover observables against the base stream per epoch.

    Attach with ``rx.obs_sinks.append(engine.push_rover_epoch)``; fixed and
    float solutions accumulate in ``solutions``.

    ``mode`` selects the positioning engine (reference
    PVT.positioning_mode): "instantaneous" solves each epoch independently
    (rtk.solve_rtk), "kinematic"/"static" run the filtered RtkFilter with
    persistent ambiguities and cycle-slip handling (rtklib relpos modes
    PMODE_KINEMA / PMODE_STATIC), "dgps" is code-only differential
    (PMODE_DGPS — no carrier bookkeeping, meter-level), and "moving_base"
    re-solves the base's own single-point position every epoch from its
    broadcast observations and reports the precise DD baseline to it
    (PMODE_MOVEB, rtklib_rtkpos.cc:2787).
    """

    def __init__(self, base: RtcmBaseStation, sigma_pr_m: float = 0.5,
                 ratio_threshold: float = 3.0,
                 mode: str = "instantaneous"):
        self.base = base
        self.sigma_pr_m = sigma_pr_m
        self.ratio_threshold = ratio_threshold
        self.mode = mode
        self._filter = None
        self.solutions: list[rtk.RtkSolution] = []

    def _solve_base_position(self, base_list: list) -> np.ndarray | None:
        """Moving-base support: the base's own single-point fix from its
        broadcast observations (rtklib PMODE_MOVEB computes the base
        position per epoch the same way). Meter-level absolute error here
        is common-mode in the double differences, so the reported BASELINE
        stays centimeter-precise."""
        from gnss_sdr_tpu_torch.receiver.pvt import solver as pvt_solver
        inputs = [pvt_solver.ObsInput(
            prn=b.prn, pseudorange_m=b.pseudorange_m,
            doppler_hz=b.doppler_hz, carrier_freq_hz=b.carrier_freq_hz,
            t_tx_sv=b.t_tx_sv, cn0_dbhz=b.cn0_dbhz, system=b.system)
            for b in base_list]
        sol = pvt_solver.solve_pvt(inputs, self.base.ephemerides,
                                   iono=None, apply_tropo=False)
        return np.asarray(sol.pos_ecef) if sol.valid else None

    def push_rover_epoch(self, tick_sample: int, observables: list) -> None:
        # a moving base broadcasts no surveyed 1005/1006 position — its
        # location is re-derived per epoch from its own observations
        if not self.base.epochs or (self.base.base_ecef is None
                                    and self.mode != "moving_base"):
            return
        o0 = observables[0]
        tow = o0.t_tx_sv + o0.pseudorange_m / constants.SPEED_OF_LIGHT_M_S
        got = self.base.epoch_near_tagged(tow)
        if got is None:
            return
        tow_base, base_obs = got
        rover = []
        base_list = []
        # pair rover/base per (system, prn, SIGNAL): mixing frequencies of
        # the same satellite would difference incompatible wavelengths
        base_by_key = {}
        for b in base_obs:
            sig = _SIG_FROM_SLOT.get((getattr(b, "system", "G"), b.signal_id))
            if sig is None:
                continue
            spec = constants.SIGNALS[sig]
            # GLONASS FDMA: the per-slot carrier (from the MSM extended
            # satellite info) decides the wavelength; using the band center
            # would bias DD phases by ~3.5e-4 of the range
            freq = (spec.carrier_freq_hz
                    + getattr(b, "freq_slot", 0) * spec.fdma_step_hz)
            lam = constants.SPEED_OF_LIGHT_M_S / freq
            base_by_key[(spec.system, b.prn, sig)] = rtk.RtkObs(
                prn=b.prn, pseudorange_m=b.pseudorange_m,
                carrier_phase_cycles=b.phase_range_m / lam,
                carrier_freq_hz=freq,
                # base transmit time from the base epoch tag (surveyed
                # station, clock near GPS time): the solvers evaluate the
                # base-side satellite positions here
                t_tx_sv=(tow_base
                         - b.pseudorange_m / constants.SPEED_OF_LIGHT_M_S),
                cn0_dbhz=b.cn0_dbhz, system=spec.system,
                # MSM phase rate is d(range)/dt; RINEX D = -d(rho)/dt/lam.
                # MSM4/legacy messages carry no rate: flag it so the slip
                # detector falls back to non-Doppler tests instead of
                # treating the base's full range rate as a phase jump
                doppler_hz=(-b.phase_rate_m_s / lam
                            if getattr(b, "has_rate", True) else 0.0),
                has_doppler=bool(getattr(b, "has_rate", True)))
        seen_sat = set()
        for o in observables:
            spec = constants.SIGNALS[o.signal]
            key = (spec.system, o.prn, o.signal)
            sat = (spec.system, o.prn)
            if key not in base_by_key or sat in seen_sat:
                continue
            seen_sat.add(sat)      # one signal per satellite in the DD set
            rover.append(rtk.RtkObs(
                prn=o.prn, pseudorange_m=o.pseudorange_m,
                carrier_phase_cycles=o.carrier_phase_cycles,
                # slot-aware carrier when the observable carries it
                # (GLONASS FDMA); nominal otherwise
                carrier_freq_hz=(getattr(o, "carrier_freq_hz", 0.0)
                                 or spec.carrier_freq_hz),
                cn0_dbhz=o.cn0_dbhz, system=spec.system,
                t_tx_sv=o.t_tx_sv, doppler_hz=o.doppler_hz))
            base_list.append(base_by_key[key])
        if len(rover) < (4 if self.mode == "dgps" else 5):
            return
        if self.mode == "dgps":
            sol = rtk.solve_dgps(rover, base_list, self.base.base_ecef,
                                 self.base.ephemerides,
                                 sigma_pr_m=self.sigma_pr_m)
        elif self.mode == "moving_base":
            base_ecef = self._solve_base_position(base_list)
            if base_ecef is None:
                return
            sol = rtk.solve_rtk(rover, base_list, base_ecef,
                                self.base.ephemerides,
                                sigma_pr_m=self.sigma_pr_m,
                                ratio_threshold=self.ratio_threshold)
        elif self.mode == "instantaneous":
            sol = rtk.solve_rtk(rover, base_list, self.base.base_ecef,
                                self.base.ephemerides,
                                sigma_pr_m=self.sigma_pr_m,
                                ratio_threshold=self.ratio_threshold)
        else:
            from gnss_sdr_tpu_torch.receiver.pvt.rtk_filter import (RtkFilter,
                                                              RtkFilterConfig)
            if self._filter is None:
                self._filter = RtkFilter(
                    self.base.base_ecef, self.base.ephemerides,
                    RtkFilterConfig(mode=self.mode,
                                    sigma_pr_m=self.sigma_pr_m,
                                    ratio_threshold=self.ratio_threshold))
            self._filter.ephemerides = self.base.ephemerides
            sol = self._filter.update(rover, base_list, tow)
        if sol.valid:
            self.solutions.append(sol)
