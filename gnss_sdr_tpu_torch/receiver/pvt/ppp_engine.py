"""PPP engine: receiver observables -> iono-free combinations -> PPP filter.

The port's copy of gnss_sdr_tpu/receiver/pvt/ppp_engine.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: the PPP positioning modes of the PVT block
(``rtklib_pvt_gs`` with PVT.positioning_mode=PPP_Static / PPP_Kinematic
driving ``pppos`` in rtklib_ppp.cc). Consumes the receiver's per-epoch
``ChannelObservable`` lists via ``rx.obs_sinks``: satellites observed on two
frequencies form dual-frequency iono-free code/phase (enabling PPP-AR via
the Melbourne-Wübbena wide lane); single-frequency satellites are skipped
(classic PPP is a dual-frequency technique).
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.receiver.pvt import ppp_ar

C_M_S = constants.SPEED_OF_LIGHT_M_S


class PppEngine:
    """Attach with ``rx.obs_sinks.append(engine.push_epoch)``."""

    def __init__(self, ephemerides: dict, x0_ecef, mode: str = "static",
                 ambiguity_resolution: bool = True,
                 sigma_pr_m: float = 1.0, sigma_phase_m: float = 0.012,
                 q_pos_m2_s: float = 1.0, estimate_tropo: bool = True,
                 obs_spacing_s: float = 0.5,
                 ratio_threshold: float = 3.0,
                 code_bias_m: float = 0.0):
        """``obs_spacing_s``: minimum time between PROCESSED epochs —
        epochs arriving faster are skipped. A receiver producing 50 Hz
        observables feeds the filter measurement noise that is strongly
        time-correlated (DLL/PLL loop bandwidths of a few Hz), which the
        white-noise filter model mistakes for 50 independent samples per
        second: the formal covariance collapses ~sqrt(f_obs*tau_corr)
        too fast and the AR gates open while the true error is still
        large. Decimating past the noise decorrelation time keeps the
        covariance honest — the same reason RTKLIB runs PPP at the RINEX
        epoch rate, not the tracking-loop rate. Default 0.5 s = ~2x the
        code-noise correlation time of a 2 Hz DLL (measured on the
        dual-band regression: 0.2 s still left the B_IF covariance
        optimistic enough for LAMBDA to accept a wrong narrow-lane set at
        ratio 90; 0.5 s keeps the formal and true covariances aligned)."""
        self.filter = ppp_ar.PppArFilter(
            ephemerides, x0_ecef=np.asarray(x0_ecef, float),
            mode=mode, q_pos_m2_s=q_pos_m2_s, estimate_tropo=estimate_tropo,
            sigma_pr_m=sigma_pr_m, sigma_phase_m=sigma_phase_m,
            code_bias_m=code_bias_m,
            # disable the integer search by an impossible ratio threshold
            ratio_threshold=(ratio_threshold if ambiguity_resolution
                             else np.inf))
        self.obs_spacing_s = float(obs_spacing_s)
        self.solutions: list = []
        self._last_tow: float | None = None
        self._prev: dict[tuple, tuple] = {}  # (sys,prn,f) -> (tow, phase, dop)
        # SSR code biases (RTCM 1059/1065/1242): (system, prn) ->
        # SsrCodeBias, applied to the raw pseudoranges before the
        # iono-free combination (rtklib corr_meas cbias role). Update via
        # set_code_biases().
        self.code_biases: dict = {}

    # RTCM signal-and-tracking-mode indices for the signals this receiver
    # tracks (per-system tables: GPS 0=L1 C/A, 7=L2C(M), 14=L5 I;
    # Galileo 1=E1 B, 14=E5a I; GLONASS 0=G1 C/A, 8=G2 C/A)
    _SSR_SIG_ID = {"1C": 0, "2S": 7, "L5": 14, "1B": 1, "5X": 14,
                   "1G": 0, "2G": 8}

    def enable_precise_models(self, *, windup: bool = True,
                              sat_pco_body_m=None,
                              com_orbits: bool = False,
                              rcv_antenna=None) -> None:
        """Turn on the precise observation-model corrections
        (pvt/corrections.py; rtklib posopt[0]/posopt[2] roles):

        - ``windup``: carrier phase wind-up, applied per frequency before
          the iono-free combination (continuous per satellite).
        - ``com_orbits``: the orbit source is center-of-mass referenced
          (SP3): apply the satellite antenna phase-center offset
          (``sat_pco_body_m`` in the body frame, default Block IIF-class)
          as a range correction.
        - ``rcv_antenna``: a corrections.ReceiverAntenna (ANTEX PCO/PCV).
        """
        from gnss_sdr_tpu_torch.receiver.pvt import corrections
        self._corrections = corrections
        self._windup_on = windup
        self._sat_pco = (np.asarray(sat_pco_body_m, float)
                         if sat_pco_body_m is not None
                         else corrections.DEFAULT_SAT_PCO_BODY_M)
        self._com_orbits = com_orbits
        self._rcv_antenna = rcv_antenna
        self._windup: dict = {}          # (system, prn) -> cycles

    def _precise_phase_corrections(self, system: str, prn: int, o1, o2,
                                   tow: float):
        """(d_phase1_cycles, d_phase2_cycles, d_range_m) to SUBTRACT from
        the measurements (add to the model) for one satellite."""
        cor = self._corrections
        from gnss_sdr_tpu_torch.receiver.pvt import geodesy

        eph = self.filter.ephemerides.get((system, prn))
        if eph is None:
            return 0.0, 0.0, 0.0
        sat = np.asarray(eph.position_velocity(o1.t_tx_sv)[0], float)
        rcv = self.filter.x[:3]
        lat, lon, _h = geodesy.ecef_to_geodetic(rcv)
        sun = cor.sun_position_ecef(tow)
        d1 = d2 = 0.0
        dr = 0.0
        if self._windup_on:
            key = (system, prn)
            w = cor.phase_windup_cycles(sat, sun, rcv, lat, lon,
                                        prev_cycles=self._windup.get(key))
            self._windup[key] = w
            d1 = d2 = w
        if self._com_orbits:
            off = cor.satellite_antenna_offset(sat, sun, self._sat_pco)
            e = (rcv - sat)
            e = e / np.linalg.norm(e)
            # phase-center range = CoM range - e.off: refer measurements
            # to the CoM model by ADDING e.off (subtract -e.off)
            dr -= float(e @ off)
        if self._rcv_antenna is not None:
            az, el = geodesy.az_el(rcv, sat)
            dr += self._rcv_antenna.correction_m(az, el)
        return d1, d2, dr

    def set_code_biases(self, biases) -> None:
        """Accept decoded 1059/1065/1242 records (list[SsrCodeBias] or a
        dict keyed by (system, prn) or bare GPS prn, e.g.
        RtcmBaseStation.ssr_code_bias)."""
        if isinstance(biases, dict):
            self.code_biases = {
                (k if isinstance(k, tuple) else ("G", k)): v
                for k, v in biases.items()}
        else:
            self.code_biases = {(b.system, b.prn): b for b in biases}

    def _corrected_pr(self, o) -> float:
        from gnss_sdr_tpu_torch import constants
        system = constants.SIGNALS[o.signal].system
        b = self.code_biases.get((system, o.prn))
        if b is None:
            return o.pseudorange_m
        from gnss_sdr_tpu_torch.receiver.pvt import rtcm
        return rtcm.apply_ssr_code_bias(
            o.pseudorange_m, b, self._SSR_SIG_ID.get(o.signal, -1))

    # --------------------------------------------------------------- slips
    def _detect_slips(self, obs_by_sat: dict, tow: float) -> set:
        slips = set()
        for (system, prn), pairs in obs_by_sat.items():
            for o in pairs:
                key = (system, prn, o.signal)
                prev = self._prev.get(key)
                if prev is not None:
                    t0, cp0, d0 = prev
                    dt = tow - t0
                    if 0.0 < dt <= 10.0:
                        pred = -0.5 * (o.doppler_hz + d0) * dt
                        if abs(o.carrier_phase_cycles - cp0 - pred) > 2.0:
                            slips.add((system, prn))
                self._prev[key] = (tow, o.carrier_phase_cycles, o.doppler_hz)
        return slips

    def seed_position(self, pos_ecef) -> None:
        """One-time position seed from the receiver's single-point fix
        (the PPP linearization needs a rough absolute position)."""
        if np.linalg.norm(self.filter.x[:3]) < 1e6:
            self.filter.x[:3] = np.asarray(pos_ecef, float)

    # --------------------------------------------------------------- epoch
    def push_epoch(self, tick_sample: int, observables: list) -> None:
        if np.linalg.norm(self.filter.x[:3]) < 1e6:
            return                       # not seeded yet
        by_sat: dict[tuple, list] = {}
        for o in observables:
            spec = constants.SIGNALS[o.signal]
            by_sat.setdefault((spec.system, o.prn), []).append(o)
        if not by_sat:
            return
        o0 = observables[0]
        tow = o0.t_tx_sv + o0.pseudorange_m / C_M_S
        if (self.obs_spacing_s > 0.0 and self._last_tow is not None
                and tow - self._last_tow < self.obs_spacing_s - 1e-9):
            return                       # decimate (see __init__ docstring)
        slips = self._detect_slips(by_sat, tow)

        obs = []
        for (system, prn), chans in by_sat.items():
            if len(chans) < 2:
                continue
            chans = sorted(chans, key=lambda o:
                           -constants.SIGNALS[o.signal].carrier_freq_hz)
            o1, o2 = chans[0], chans[1]
            f1 = constants.SIGNALS[o1.signal].carrier_freq_hz
            f2 = constants.SIGNALS[o2.signal].carrier_freq_hz
            if f1 == f2:
                continue
            lam1, lam2 = C_M_S / f1, C_M_S / f2
            a1 = f1 * f1 / (f1 * f1 - f2 * f2)
            a2 = f2 * f2 / (f1 * f1 - f2 * f2)
            p1 = self._corrected_pr(o1)
            p2 = self._corrected_pr(o2)
            l1 = o1.carrier_phase_cycles
            l2 = o2.carrier_phase_cycles
            if getattr(self, "_corrections", None) is not None:
                # precise models: wind-up per frequency + antenna range
                # terms (pr and phase alike)
                dw1, dw2, dr = self._precise_phase_corrections(
                    system, prn, o1, o2, tow)
                l1 -= dw1
                l2 -= dw2
                p1 -= dr
                p2 -= dr
                l1 -= dr / lam1
                l2 -= dr / lam2
            obs.append(ppp_ar.PppArObs(
                prn=prn, system=system, t_tx_sv=o1.t_tx_sv,
                pr_if_m=a1 * p1 - a2 * p2,
                phase_if_m=a1 * l1 * lam1 - a2 * l2 * lam2,
                p1_m=p1, p2_m=p2,
                l1_cycles=l1, l2_cycles=l2,
                f1_hz=f1, f2_hz=f2))
        if len(obs) < 4:
            return
        dt = (tow - self._last_tow) if self._last_tow is not None else 1.0
        self._last_tow = tow
        sol = self.filter.update(obs, dt_s=max(dt, 1e-3), slips=slips)
        if sol.valid:
            self.solutions.append(sol)
