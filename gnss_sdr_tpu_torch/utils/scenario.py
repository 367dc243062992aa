"""Full signal-level simulation scenario: constellation -> IQ samples.

The system-test enabler (reference analog: the external gnss-sim spawned by
``position_test.cc``): picks visible satellites for a receiver truth position,
fits each satellite's transmit-time trajectory to the generator's
(delay, doppler, doppler-rate) model, attaches real navigation symbols
(LNAV, I/NAV, CNAV, F/NAV, BeiDou D1), and returns
everything needed to synthesize IQ and to verify the receiver's output
against absolute truth.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import gps_lnav
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.utils import constellation, generator


@dataclasses.dataclass
class Scenario:
    rcv_ecef: np.ndarray        # position at t0 (sample 0)
    rcv_llh: tuple
    t0_gps: float               # GPS time at receiver sample 0
    tow_bits_start: float       # SV time of LNAV bit 0
    duration_s: float
    fs: float
    ephemerides: dict[int, KeplerEphemeris]
    sats: list[generator.SatParams]
    prns: list[int]
    spec: constants.SignalSpec = constants.GPS_L1_CA
    # constant-velocity receiver motion (dynamic system test; the reference
    # asserts against a Spirent motion file, position_test.cc:803-804)
    rcv_vel_ecef: np.ndarray | None = None

    def generate(self, seed: int = 0, noise: bool = True,
                 **kw) -> np.ndarray:
        """The scenario's IQ; ``kw`` goes to :func:`generator.generate`
        (``with_pilot``, ``device``)."""
        return generator.generate(self.spec, self.sats, self.fs,
                                  self.duration_s, seed=seed, noise=noise,
                                  **kw)

    def rcv_pos_at(self, t_since_t0: float) -> np.ndarray:
        """Truth receiver position t seconds after sample 0."""
        if self.rcv_vel_ecef is None:
            return self.rcv_ecef
        return self.rcv_ecef + self.rcv_vel_ecef * t_since_t0


def _fit_t_tx(eph, rcv_at, t0: float, duration_s: float):
    """Cubic fit of the SV transmit-time trajectory, done in SMALL numbers.

    Fits y(t) = t_reception - t_tx_sv = tau - dt_sv (ObsInput.t_offset_s,
    ~0.07 s) instead of t_tx_sv itself (~3.5e5 s, where one float64 ulp is
    5.8e-11 s = 1.7 cm of range: fitting the big value floors every
    carrier-phase test at the cm level; RTKLIB splits time int+frac for
    the same reason). Returns (a3, a2, a1, a0) of
    t_tx_sv(t) ~ a0 + a1 t + a2 t^2 + a3 t^3 — a0 carries the one
    unavoidable large-magnitude constant.
    """
    ts = np.linspace(0.0, duration_s, 8)
    ys = np.array([constellation.simulate_observation(
        eph, rcv_at(t), t0 + t).t_offset_s for t in ts])
    y3, y2, y1, y0 = np.polyfit(ts, ys, 3)
    return -y3, -y2, 1.0 - y1, t0 - y0


def _geometric_phase0(fc: float, t_tx0: float) -> float:
    """Carrier phase (cycles, mod 1) at receiver t=0 implied by geometry.

    The received baseband phase is fc*(t_tx(t) - t); a zero phase constant
    would add an arbitrary real offset per satellite, destroying the
    integer structure of carrier-phase ambiguities that PPP-AR/RTK exploit
    (real signals are phase-locked to the satellite clock that also times
    the code). float64 cannot form fc*t_tx mod 1 (ulp ~0.1 cycle at 5e14);
    x86 80-bit longdouble leaves ~1e-4 cycles.
    """
    return float(np.mod(np.longdouble(fc) * np.longdouble(t_tx0), 1.0))


def build_gps_l1_scenario(rcv_llh=(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0),
                          t0_gps: float = 352800.08, duration_s: float = 28.0,
                          fs: float = 2.046e6, n_sats: int = 6,
                          cn0_dbhz: float = 47.0,
                          vel_enu: tuple = (0.0, 0.0, 0.0)) -> Scenario:
    """Build a GPS L1 C/A scenario on the almanac constellation, static or
    with the receiver at the constant velocity ``vel_enu`` (m/s east, north,
    up) (the JAX package's function without its SBAS and almanac-page
    options).

    The LNAV streams cycle subframes (1,2,3) so ephemeris is decodable within
    ~25 s of signal. SV transmit-time trajectories are CUBIC fits of the exact
    light-time solution (the quadratic fit left cm-level elevation-
    correlated carrier drifts that floored phase-based positioning tests
    at ~dm; the cubic residual over 60 s is micrometric).
    """
    ephs = constellation.almanac_constellation()
    for e in ephs.values():
        e.tgd = 0.0   # signal-level sim carries no inter-signal group delay
    rcv = geodesy.geodetic_to_ecef(*rcv_llh)
    moving = any(v != 0.0 for v in vel_enu)
    vel_ecef = (geodesy.enu_to_ecef_offset(
        np.asarray(vel_enu, float), rcv_llh[0], rcv_llh[1])
        if moving else None)

    def rcv_at(t: float) -> np.ndarray:
        return rcv + vel_ecef * t if moving else rcv

    vis = constellation.visible_sats(ephs, rcv, t0_gps, el_mask_deg=15.0)
    chosen = [prn for prn, _, _ in vis[:n_sats]]
    if len(chosen) < n_sats:
        raise RuntimeError(f"only {len(chosen)} visible sats")

    fc = constants.GPS_L1_CA.carrier_freq_hz
    code_rate = constants.GPS_L1_CA.code_rate_cps

    # common LNAV bit-stream origin: latest 6 s boundary before min t_tx(0)
    t_tx0 = {}
    for prn in chosen:
        o = constellation.simulate_observation(ephs[prn], rcv, t0_gps)
        t_tx0[prn] = o.t_tx_sv
    tow_bits_start = 6.0 * np.floor(min(t_tx0.values()) / 6.0)

    n_subframes = int(np.ceil((duration_s + 12.0) / 6.0)) + 1
    sats = []
    for prn in chosen:
        eph = ephs[prn]
        # quadratic fit of t_tx_sv(t), t = receiver time since sample 0
        a3, a2, a1, a0 = _fit_t_tx(eph, rcv_at, t0_gps, duration_s)
        doppler = fc * (a1 - 1.0)
        doppler_rate = fc * 2.0 * a2
        doppler_jerk = fc * 6.0 * a3
        # generator model: chip_phase(t) = R*(t - d + (fd*t + 0.5*r*t^2)/fc)
        # matching R*(t_tx_sv(t) - tow_bits_start) termwise gives d = tow - a0
        code_delay = tow_bits_start - a0
        bits = generator.lnav_bits_to_symbols(gps_lnav.encode_frames(
            eph, tow_bits_start, n_subframes, sfid_cycle=(1, 2, 3)))
        sats.append(generator.SatParams(
            prn=prn, cn0_dbhz=cn0_dbhz, doppler_hz=doppler,
            carrier_phase_cycles=_geometric_phase0(fc, a0),
            doppler_rate_hz_s=doppler_rate, doppler_jerk_hz_s2=doppler_jerk,
            code_delay_s=code_delay, data_bits=bits))

    sc = Scenario(rcv_ecef=rcv, rcv_llh=rcv_llh, t0_gps=t0_gps,
                  tow_bits_start=tow_bits_start, duration_s=duration_s,
                  fs=fs, ephemerides=ephs, sats=sats, prns=chosen,
                  rcv_vel_ecef=vel_ecef)
    return sc


def build_galileo_e1_scenario(rcv_llh=(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0),
                              t0_gps: float = 352800.13, duration_s: float = 18.0,
                              fs: float = 4.0e6, n_sats: int = 5,
                              cn0_dbhz: float = 48.0,
                              vis_offset: int = 0,
                              el_mask_deg: float = 15.0) -> Scenario:
    """Galileo E1-B (CBOC-as-BOC(1,1)) signal-level scenario with I/NAV.

    Pages cycle word types 1..5 (2 s each), so the full ephemeris + GST
    anchor arrive within 10 s of page sync.

    ``vis_offset`` skips the first K entries of the elevation-sorted
    visible list. The GPS and Galileo builders share one simulated
    constellation, so a hybrid scenario built from both with offset 0
    puts a Galileo satellite at every GPS satellite's position — the
    mixed fix then has the DOP of a single 4-satellite set plus an extra
    clock unknown. An offset gives the second system disjoint geometry,
    as a real sky would.
    """
    from gnss_sdr_tpu_torch.models.nav import galileo_inav

    spec = constants.GALILEO_E1_B
    ephs = constellation.almanac_constellation()
    for e in ephs.values():
        e.tgd = 0.0
        e.gm = constants.GM_EARTH_GAL
    rcv = geodesy.geodetic_to_ecef(*rcv_llh)
    vis = constellation.visible_sats(ephs, rcv, t0_gps,
                                     el_mask_deg=el_mask_deg)
    chosen = [prn for prn, _, _ in vis[vis_offset: vis_offset + n_sats]]
    if len(chosen) < n_sats:
        raise RuntimeError(f"only {len(chosen)} visible sats")

    fc = spec.carrier_freq_hz
    t_tx0 = {prn: constellation.simulate_observation(ephs[prn], rcv, t0_gps).t_tx_sv
             for prn in chosen}
    # symbol stream origin: a 2 s page boundary before the earliest t_tx(0)
    tow_sym_start = 2.0 * np.floor(min(t_tx0.values()) / 2.0)
    n_pages = int(np.ceil((duration_s + 4.0) / 2.0)) + 1

    sats = []
    for prn in chosen:
        eph = ephs[prn]
        a3, a2, a1, a0 = _fit_t_tx(eph, lambda _t: rcv, t0_gps,
                                   duration_s)
        symbols = galileo_inav.encode_stream(eph, tow_sym_start, n_pages)
        sats.append(generator.SatParams(
            prn=prn, cn0_dbhz=cn0_dbhz,
            carrier_phase_cycles=_geometric_phase0(fc, a0),
            doppler_hz=fc * (a1 - 1.0), doppler_rate_hz_s=fc * 2.0 * a2,
            doppler_jerk_hz_s2=fc * 6.0 * a3,
            code_delay_s=tow_sym_start - a0,
            data_bits=generator.lnav_bits_to_symbols(symbols)))

    return Scenario(rcv_ecef=rcv, rcv_llh=rcv_llh, t0_gps=t0_gps,
                    tow_bits_start=tow_sym_start, duration_s=duration_s,
                    fs=fs, ephemerides=ephs, sats=sats, prns=chosen,
                    spec=spec)


def build_gps_l5_scenario(rcv_llh=(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0),
                          t0_gps: float = 352800.06, duration_s: float = 30.0,
                          fs: float = 11.0e6, n_sats: int = 4,
                          cn0_dbhz: float = 50.0,
                          el_mask_deg: float = 15.0) -> Scenario:
    """GPS L5I signal-level scenario with CNAV (6 s messages, 100 sps).

    The 10.23 Mcps L5 code needs fs > 10.23 MHz; 11 MHz keeps sampling
    incommensurate with the chip rate (no flat-peak DLL bias). CNAV cycles
    message types 10/11/30 so the ephemeris completes within 18 s of frame
    sync (reference: gps_l5_telemetry_decoder_gs.cc timing). The worst-case
    budget is ~2 s tracking start + ~6 s to the next message anchor + 18 s
    for a full 10/11/30 cycle = 26 s; 30 s leaves margin for the
    last-acquired channel.
    """
    from gnss_sdr_tpu_torch.models.nav import gps_cnav

    spec = constants.GPS_L5_I
    ephs = constellation.almanac_constellation()
    for e in ephs.values():
        e.tgd = 0.0
    rcv = geodesy.geodetic_to_ecef(*rcv_llh)
    vis = constellation.visible_sats(ephs, rcv, t0_gps,
                                     el_mask_deg=el_mask_deg)
    chosen = [prn for prn, _, _ in vis[:n_sats]]
    if len(chosen) < n_sats:
        raise RuntimeError(f"only {len(chosen)} visible sats")

    fc = spec.carrier_freq_hz
    t_tx0 = {prn: constellation.simulate_observation(
        ephs[prn], rcv, t0_gps).t_tx_sv for prn in chosen}
    # symbol-stream origin: a 6 s CNAV message boundary before min t_tx(0)
    tow_sym_start = 6.0 * np.floor(min(t_tx0.values()) / 6.0)
    n_messages = int(np.ceil((duration_s + 12.0) / 6.0)) + 1

    sats = []
    for prn in chosen:
        eph = ephs[prn]
        a3, a2, a1, a0 = _fit_t_tx(eph, lambda _t: rcv, t0_gps,
                                   duration_s)
        sym = gps_cnav.encode_symbol_stream(eph, tow_sym_start, n_messages,
                                            period_s=6.0)
        sats.append(generator.SatParams(
            prn=prn, cn0_dbhz=cn0_dbhz,
            carrier_phase_cycles=_geometric_phase0(fc, a0),
            doppler_hz=fc * (a1 - 1.0), doppler_rate_hz_s=fc * 2.0 * a2,
            doppler_jerk_hz_s2=fc * 6.0 * a3,
            code_delay_s=tow_sym_start - a0,
            data_bits=generator.lnav_bits_to_symbols(sym)))

    return Scenario(rcv_ecef=rcv, rcv_llh=rcv_llh, t0_gps=t0_gps,
                    tow_bits_start=tow_sym_start, duration_s=duration_s,
                    fs=fs, ephemerides=ephs, sats=sats, prns=chosen,
                    spec=spec)


def build_gps_l2c_scenario(rcv_llh=(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0),
                           t0_gps: float = 352800.07, duration_s: float = 58.0,
                           fs: float = 2.0e6, n_sats: int = 4,
                           cn0_dbhz: float = 45.0) -> Scenario:
    """GPS L2 CM signal-level scenario with CNAV (12 s messages, 50 sps).

    One 20 ms CM code period per FEC symbol; the convolutional stream is
    continuous across messages. CM-only model (the chip-by-chip CM/CL time
    multiplex carries no extra information for a CM correlator; the
    reference's L2C chain likewise correlates against the CM code,
    gps_l2c_signal.cc + GetChannel_2S). Ephemeris needs messages 10+11 (+30
    for clock) = a full 36 s cycle after frame sync, hence the ~58 s
    default. 2.0 Msps is incommensurate with the 511.5 kcps chip rate.
    """
    from gnss_sdr_tpu_torch.models.nav import gps_cnav

    spec = constants.GPS_L2_CM
    ephs = constellation.almanac_constellation()
    for e in ephs.values():
        e.tgd = 0.0
    rcv = geodesy.geodetic_to_ecef(*rcv_llh)
    vis = constellation.visible_sats(ephs, rcv, t0_gps, el_mask_deg=15.0)
    chosen = [prn for prn, _, _ in vis[:n_sats]]
    if len(chosen) < n_sats:
        raise RuntimeError(f"only {len(chosen)} visible sats")

    fc = spec.carrier_freq_hz
    t_tx0 = {prn: constellation.simulate_observation(
        ephs[prn], rcv, t0_gps).t_tx_sv for prn in chosen}
    # symbol-stream origin: a 12 s CNAV message boundary before min t_tx(0)
    tow_sym_start = 12.0 * np.floor(min(t_tx0.values()) / 12.0)
    n_messages = int(np.ceil((duration_s + 24.0) / 12.0)) + 1

    sats = []
    for prn in chosen:
        eph = ephs[prn]
        a3, a2, a1, a0 = _fit_t_tx(eph, lambda _t: rcv, t0_gps,
                                   duration_s)
        sym = gps_cnav.encode_symbol_stream(eph, tow_sym_start, n_messages,
                                            period_s=12.0)
        sats.append(generator.SatParams(
            prn=prn, cn0_dbhz=cn0_dbhz,
            carrier_phase_cycles=_geometric_phase0(fc, a0),
            doppler_hz=fc * (a1 - 1.0), doppler_rate_hz_s=fc * 2.0 * a2,
            doppler_jerk_hz_s2=fc * 6.0 * a3,
            code_delay_s=tow_sym_start - a0,
            data_bits=generator.lnav_bits_to_symbols(sym)))

    return Scenario(rcv_ecef=rcv, rcv_llh=rcv_llh, t0_gps=t0_gps,
                    tow_bits_start=tow_sym_start, duration_s=duration_s,
                    fs=fs, ephemerides=ephs, sats=sats, prns=chosen,
                    spec=spec)


def build_glonass_l1_scenario(rcv_llh=(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0),
                              t0_day: float = 40000.12,
                              fs: float = 8.0e6, n_sats: int = 4,
                              cn0_dbhz: float = 48.0,
                              margin_s: float = 7.0,
                              freq_slots: tuple = (
                                  1, -4, 5, 6, 1, -4, 5, 6, -2, -7, 0, -1,
                                  -2, -7, 0, -1, 4, -3, 3, 2, 4, -3, 3, 2),
                              band: str = "1G") -> Scenario:
    """GLONASS C/A FDMA scenario (``band`` 1G or 2G): state-vector
    (PZ-90-style) truth + timing-correct GNAV frames, each satellite at its
    slot IF (562.5 kHz steps on L1, 437.5 kHz on L2; the C/A code and the
    GNAV message are identical on both bands).

    Truth ephemerides are GlonassEphemeris state vectors sampled from the
    Kepler almanac orbits and then propagated with the SAME RK4 model the
    receiver uses — fully self-consistent. Slots are restricted to
    |k| <= 5 so all carriers fit inside ``fs`` (|IF| <= 2.81 MHz + code
    bandwidth < 4 MHz Nyquist at 8 Msps). The stream origin is
    chosen so the receiver's first full frame starts ~2 s in (ephemeris
    strings 1-4 arrive within ~10 s). Reference analog: the Channels_1G
    chain (GLONASS_L1_CA_* adapters, glonass_l1_ca_telemetry_decoder_gs).
    """
    from gnss_sdr_tpu_torch.models.nav import glonass_gnav

    spec = constants.SIGNALS[band]
    assert spec.system == "R", band
    rcv = geodesy.geodetic_to_ecef(*rcv_llh)
    # sample visible Kepler-almanac orbits into state vectors
    kep = constellation.almanac_constellation()
    t_kref = 352800.0
    vis = constellation.visible_sats(kep, rcv, t_kref, el_mask_deg=20.0)
    chosen = [prn for prn, _, _ in vis
              if prn <= len(freq_slots) and abs(freq_slots[prn - 1]) <= 5]
    chosen = chosen[:n_sats]
    if len(chosen) < n_sats:
        raise RuntimeError(f"only {len(chosen)} usable slots visible")

    # ephemeris epoch tb: the 900 s boundary covering the scenario
    tb = 900.0 * round(t0_day / 900.0)
    ephs: dict = {}
    for prn in chosen:
        p, v = kep[prn].position_velocity(t_kref + (tb - t0_day))
        ephs[("R", prn)] = glonass_gnav.GlonassEphemeris(
            slot=prn, freq_slot=freq_slots[prn - 1], tb_s=tb,
            pos_m=tuple(p), vel_m_s=tuple(v), acc_m_s2=(0.0, 0.0, 0.0),
            gamma_n=0.0, tau_n=0.0)

    t_tx0 = {prn: constellation.simulate_observation(
        ephs[("R", prn)], rcv, t0_day).t_tx_sv for prn in chosen}
    # frame origin: receiver t=0 lands ~2 s BEFORE a frame boundary, so the
    # first fully-received frame carries strings 1-4 right after pull-in
    tk0 = 30.0 * np.floor(min(t_tx0.values()) / 30.0 + 1.0)
    if tk0 - min(t_tx0.values()) < 3.0:      # leave pull-in time before it
        tk0 += 30.0
    duration_s = float((tk0 - min(t_tx0.values())) + 10.0 + margin_s)
    n_frames = int(np.ceil(duration_s / 30.0)) + 2
    stream_t0 = tk0 - 30.0       # include one leading frame for sync

    sats_by_if: list[tuple[float, generator.SatParams]] = []
    for prn in chosen:
        eph = ephs[("R", prn)]
        a3, a2, a1, a0 = _fit_t_tx(eph, lambda _t: rcv, t0_day,
                                   duration_s)
        k = freq_slots[prn - 1]
        # the generator couples code rate to doppler/f_center, and the
        # receiver's velocity model also uses the band-center carrier, so
        # the sim doppler must be band-center-consistent: using the slot
        # carrier here would leak a k-proportional code-rate error
        # (~0.05 chips over 40 s at k=4 = tens of meters of drift)
        fc = spec.carrier_freq_hz
        symbols = glonass_gnav.encode_frame_stream(eph, stream_t0,
                                                   n_frames + 1)
        sats_by_if.append((k * spec.fdma_step_hz, generator.SatParams(
            prn=prn, cn0_dbhz=cn0_dbhz,
            carrier_phase_cycles=_geometric_phase0(fc, a0),
            doppler_hz=fc * (a1 - 1.0), doppler_rate_hz_s=fc * 2.0 * a2,
            doppler_jerk_hz_s2=fc * 6.0 * a3,
            code_delay_s=stream_t0 - a0,
            data_bits=generator.lnav_bits_to_symbols(symbols))))

    sc = Scenario(rcv_ecef=rcv, rcv_llh=rcv_llh, t0_gps=t0_day,
                  tow_bits_start=stream_t0, duration_s=duration_s,
                  fs=fs, ephemerides=ephs, sats=[s for _, s in sats_by_if],
                  prns=chosen, spec=spec)

    def _generate(seed: int = 0, noise: bool = True,
                  device=None) -> np.ndarray:
        # each satellite at its own slot IF: per-sat clean generation + one
        # shared noise floor (the generator's if_freq is global); the
        # signal sums on the torch ``device`` (the CPU when None)
        n = int(round(fs * sc.duration_s))
        x = np.zeros(n, np.complex64)
        for f_if, sp in sats_by_if:
            x = x + generator.generate(spec, [sp], fs, sc.duration_s,
                                       if_freq_hz=f_if, noise=False,
                                       device=device)
        if noise:
            rng = np.random.default_rng(seed)
            x = (x + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
                 / np.sqrt(2.0)).astype(np.complex64)
        return x.astype(np.complex64)

    sc.generate = _generate
    return sc


def build_beidou_b1i_scenario(rcv_llh=(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0),
                              t0_gps: float = 352800.09,
                              duration_s: float = 30.0,
                              fs: float = 4.0e6, n_sats: int = 4,
                              cn0_dbhz: float = 48.0,
                              band: str = "B1") -> Scenario:
    """BeiDou B1I/B3I (MEO/IGSO D1) scenario: NH20 overlay + 6 s subframes
    (the JAX package's function without its almanac-page option).

    ``band`` B3 swaps in the 10.23 Mcps B3I code at 1268.52 MHz (same D1
    message, same NH20 overlay; reference Channels_B3 /
    BEIDOU_B3I_* adapters) — use fs > 11 Msps, incommensurate.

    Subframes cycle FraID (1,2,3) with per-slot SOW so the ephemeris
    (subframes 1-3, beidou_d1.D1Assembler) completes within ~20 s of NH
    sync. PRNs are restricted to >= 6 (GEO PRNs 1-5 transmit D2 at 500
    sps). Reference analog: the Channels_B1 chain (BEIDOU_B1I_* adapters +
    beidou_b1i_telemetry_decoder_gs.cc).
    """
    from gnss_sdr_tpu_torch.models.nav import beidou_d1

    spec = constants.SIGNALS[band]
    assert spec.system == "C", band
    ephs = constellation.almanac_constellation()
    for e in ephs.values():
        e.tgd = 0.0
        e.gm = constants.GM_EARTH_BDS
    rcv = geodesy.geodetic_to_ecef(*rcv_llh)
    vis = constellation.visible_sats(ephs, rcv, t0_gps, el_mask_deg=15.0)
    chosen = [prn for prn, _, _ in vis if prn >= 6][:n_sats]
    if len(chosen) < n_sats:
        raise RuntimeError(f"only {len(chosen)} visible MEO sats")

    fc = spec.carrier_freq_hz
    t_tx0 = {prn: constellation.simulate_observation(
        ephs[prn], rcv, t0_gps).t_tx_sv for prn in chosen}
    tow_bits_start = 6.0 * np.floor(min(t_tx0.values()) / 6.0)
    n_subframes = int(np.ceil((duration_s + 12.0) / 6.0)) + 1

    sats = []
    for prn in chosen:
        eph = ephs[prn]
        a3, a2, a1, a0 = _fit_t_tx(eph, lambda _t: rcv, t0_gps,
                                   duration_s)
        subframes = [beidou_d1.encode_subframe(
            (k % 3) + 1, tow_bits_start + 6.0 * k, eph)
            for k in range(n_subframes)]
        bits = np.concatenate(subframes)
        sats.append(generator.SatParams(
            prn=prn, cn0_dbhz=cn0_dbhz,
            carrier_phase_cycles=_geometric_phase0(fc, a0),
            doppler_hz=fc * (a1 - 1.0), doppler_rate_hz_s=fc * 2.0 * a2,
            doppler_jerk_hz_s2=fc * 6.0 * a3,
            code_delay_s=tow_bits_start - a0,
            data_bits=generator.lnav_bits_to_symbols(bits)))

    return Scenario(rcv_ecef=rcv, rcv_llh=rcv_llh, t0_gps=t0_gps,
                    tow_bits_start=tow_bits_start, duration_s=duration_s,
                    fs=fs, ephemerides=ephs, sats=sats, prns=chosen,
                    spec=spec)


def build_galileo_e5a_scenario(rcv_llh=(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0),
                               t0_gps: float = 352800.11,
                               fs: float = 12.0e6, n_sats: int = 4,
                               cn0_dbhz: float = 50.0,
                               margin_s: float = 7.0) -> Scenario:
    """Galileo E5a-I (10.23 Mcps, CS20 overlay) scenario with F/NAV.

    F/NAV pages last 10 s and the ephemeris needs IOD-matched types 1+2+3
    (galileo_fnav.FnavAssembler); the page cycle is rotated so the first
    page the receiver sees in full is type 1, and the duration is computed
    to cover the 1-2-3 set plus ``margin_s`` of fix time. Reference analog:
    the Channels_5X chain (galileo_e5a_* adapters + FNAV decoder).
    """
    from gnss_sdr_tpu_torch.models.nav import galileo_fnav

    spec = constants.GALILEO_E5A_I
    ephs = constellation.almanac_constellation()
    for e in ephs.values():
        e.tgd = 0.0
        e.gm = constants.GM_EARTH_GAL
    rcv = geodesy.geodetic_to_ecef(*rcv_llh)
    vis = constellation.visible_sats(ephs, rcv, t0_gps, el_mask_deg=15.0)
    chosen = [prn for prn, _, _ in vis[:n_sats]]
    if len(chosen) < n_sats:
        raise RuntimeError(f"only {len(chosen)} visible sats")

    fc = spec.carrier_freq_hz
    t_tx0 = {prn: constellation.simulate_observation(
        ephs[prn], rcv, t0_gps).t_tx_sv for prn in chosen}
    # page origin: the 10 s slot containing the earliest t_tx(0); slot 0 is
    # only partially received, so rotate the cycle to 4,1,2,3 — the
    # ephemeris completes at the end of slot 3 (origin + 40 s)
    tow_page_start = 10.0 * np.floor(min(t_tx0.values()) / 10.0)
    offset0 = min(t_tx0.values()) - tow_page_start
    duration_s = float(40.0 - offset0 + margin_s)
    n_pages = int(np.ceil((duration_s + offset0) / 10.0)) + 2

    sats = []
    for prn in chosen:
        eph = ephs[prn]
        a3, a2, a1, a0 = _fit_t_tx(eph, lambda _t: rcv, t0_gps,
                                   duration_s)
        symbols = galileo_fnav.encode_stream(eph, tow_page_start, n_pages,
                                             wn=eph.week, page_offset=3)
        sats.append(generator.SatParams(
            prn=prn, cn0_dbhz=cn0_dbhz,
            carrier_phase_cycles=_geometric_phase0(fc, a0),
            doppler_hz=fc * (a1 - 1.0), doppler_rate_hz_s=fc * 2.0 * a2,
            doppler_jerk_hz_s2=fc * 6.0 * a3,
            code_delay_s=tow_page_start - a0,
            data_bits=generator.lnav_bits_to_symbols(symbols)))

    return Scenario(rcv_ecef=rcv, rcv_llh=rcv_llh, t0_gps=t0_gps,
                    tow_bits_start=tow_page_start, duration_s=duration_s,
                    fs=fs, ephemerides=ephs, sats=sats, prns=chosen,
                    spec=spec)


# 5 satellites (prn, Doppler Hz, code delay s) per signal for
# tracking_handoff_case (Galileo delays within its 4 ms code period)
_HANDOFF_SATS = {
    "1C": ((3, 1200.0, 1.1e-4), (7, -2400.0, 3.3e-4), (11, 350.0, 6.1e-4),
           (19, 3900.0, 8.4e-4), (24, -800.0, 2.0e-4)),
    "1B": ((5, 1100.0, 3.1e-4), (19, -2300.0, 1.7e-3), (17, 420.0, 2.9e-3),
           (10, 3600.0, 6.3e-4), (24, -900.0, 3.7e-3)),
    "L5": ((1, 1500.0, 1.3e-4), (6, -2100.0, 4.1e-4), (9, 520.0, 7.7e-4),
           (17, 3300.0, 9.2e-4), (24, -700.0, 2.6e-4)),
    "5X": ((11, 1250.0, 2.2e-4), (12, -2600.0, 5.3e-4), (19, 610.0, 8.1e-4),
           (26, 3100.0, 9.6e-5), (33, -950.0, 4.4e-4)),
    "2S": ((2, 1150.0, 2.3e-3), (5, -2200.0, 7.9e-3), (13, 480.0, 1.17e-2),
           (21, 3400.0, 1.63e-2), (30, -850.0, 4.1e-3)),
    "B1": ((6, 1300.0, 1.9e-4), (9, -2500.0, 4.6e-4), (14, 570.0, 7.3e-4),
           (27, 3200.0, 9.1e-4), (33, -750.0, 3.2e-4)),
    "B3": ((7, 1350.0, 2.7e-4), (10, -2450.0, 5.9e-4), (12, 540.0, 8.6e-4),
           (23, 3050.0, 1.4e-4), (30, -820.0, 4.8e-4)),
    "1G": ((2, 1250.0, 1.7e-4), (9, -2350.0, 4.9e-4), (11, 610.0, 7.1e-4),
           (17, 3350.0, 9.3e-4), (22, -780.0, 3.6e-4)),
    "2G": ((3, 1180.0, 2.4e-4), (10, -2280.0, 5.6e-4), (15, 450.0, 8.2e-4),
           (18, 3150.0, 1.2e-4), (24, -900.0, 4.1e-4)),
}
# default sample rates of tracking_handoff_case (the JAX e2e tests' rates)
_HANDOFF_FS = {"1C": 2.0e6, "1B": 4.0e6, "L5": 11.0e6, "5X": 12.0e6,
               "2S": 2.0e6, "B1": 4.0e6, "B3": 12.0e6, "1G": 8.0e6,
               "2G": 6.0e6}
# GLONASS FDMA slots k of the five handoff satellites: both ends of the
# band (-7, +6) and its centre
_HANDOFF_SLOTS = {"1G": (-7, 0, 6, 3, -2), "2G": (6, -7, 0, -4, 2)}


def _handoff_sats(signal: str) -> list:
    return [generator.SatParams(prn=p, cn0_dbhz=45.0 + i, doppler_hz=d,
                                code_delay_s=cd)
            for i, (p, d, cd) in enumerate(_HANDOFF_SATS[signal])]


@functools.lru_cache(maxsize=8)
def _handoff_chunk(signal: str, fs: float, n: int, seed: int) -> np.ndarray:
    """The n samples [n, 2] float32 of tracking_handoff_case's satellites
    (with the pilot where the signal has one), made once per argument set:
    the cases of one signal, rate and seed share them."""
    from gnss_sdr_tpu_torch.models import codes

    spec = constants.SIGNALS[signal]
    sats = _handoff_sats(signal)
    slots = _HANDOFF_SLOTS.get(signal)
    if slots is None:
        x = generator.generate(spec, sats, fs, n / fs, seed=seed,
                               with_pilot=codes.has_pilot(signal))
    else:
        # each satellite at its slot IF on one noise floor, as
        # build_glonass_l1_scenario sums them
        x = sum(generator.generate(spec, [sp], fs, n / fs, noise=False,
                                   if_freq_hz=k * spec.fdma_step_hz)
                for k, sp in zip(slots, sats))
        rng = np.random.default_rng(seed)
        x = x + (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
            / np.sqrt(2.0)
    chunk = np.stack([x.real, x.imag], -1).astype(np.float32)
    chunk.setflags(write=False)
    return chunk


def tracking_handoff_case(device, *, signal: str = "1C", pilot: bool = False,
                          chunks: int = 1, extended: bool = False,
                          n_channels: int = 6, fs: float | None = None,
                          seed: int = 11) -> dict:
    """An open-loop tracking input: 5 generated satellites of ``signal``
    ("1C": GPS L1 C/A at 2 MSps; "1B": Galileo E1-B with its E1-C pilot at
    4 MSps, BOC(1,1) tables at 2 entries per chip; "L5": GPS L5I with its
    NH10 overlay and the L5Q pilot at 11 MSps; "5X": Galileo E5a-I with its
    CS20 overlay and the E5a-Q / CS100 pilot at 12 MSps; "2S": GPS L2 CM,
    one 20 ms code epoch per step, at 2 MSps; "B1" / "B3": BeiDou B1I /
    B3I with the NH20 overlay at 4 / 12 MSps; "1G" / "2G": GLONASS L1 / L2
    C/A at 8 / 6 MSps, each satellite at its FDMA slot's IF, slots -7, 0,
    +6, +3 and -2 on L1, +6, -7, 0, -4 and +2 on L2), 45-49 dB-Hz, on
    ``n_channels`` channels, every channel but the last (idle) handed off to
    satellite ``ch % 5`` slightly off the truth (+15 Hz in code rate, 15 Hz
    steps of Doppler error), over one dispatch of ``chunks`` 100 ms chunks
    plus the halo. ``pilot`` tracks the pilot with a data prompt ([C, 2, Lt]
    tables). ``extended`` switches channel 1 to coherent integration over a
    bit or symbol (20 epochs for GPS L1, 5 for Galileo E1, one secondary
    code period for L5 / E5a / B1I / B3I) and channel 3 (on fewer than 5
    channels: the last live one) to the same with a secondary-code wipe (a
    10-chip code for GPS L1, the E1-C CS25 for Galileo E1, the data
    component's NH10 / CS20 / NH20 for L5 / E5a / B1I / B3I, as the
    receiver installs it after symbol sync). L2C and GLONASS have no
    extended case.

    Returns dict(cfg, chunk [L, 2] float32 numpy, state (the carry on
    ``device``), tables [C, Lt] or [C, 2, Lt] float32 numpy, sec [C, 32]
    float32 numpy or None)."""
    import dataclasses as _dc

    from gnss_sdr_tpu_torch.models import codes
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    spec = constants.SIGNALS[signal]
    fs = fs or _HANDOFF_FS[signal]
    cfg = trk.default_config(spec, fs, 100, track_pilot=pilot)
    if chunks > 1:
        cl = cfg.chunk_len * chunks
        cfg = _dc.replace(cfg, chunk_len=cl, n_steps=int(
            np.ceil(cl / cfg.samples_per_code)) + 2)
    sats = _handoff_sats(signal)
    slots = _HANDOFF_SLOTS.get(signal)
    # a copy: the cached samples stay as generated
    chunk = _handoff_chunk(signal, fs, cfg.chunk_len + cfg.n_max,
                           seed).copy()
    n_ch = n_channels
    state = trk.init_state(n_ch, cfg.n_taps, device=device)
    lt = spec.code_length_chips * cfg.table_rate
    tables = np.zeros((n_ch, 2, lt) if pilot else (n_ch, lt), np.float32)
    sub = np.tile([1.0, -1.0], spec.code_length_chips).astype(np.float32)

    def table(chips):
        return np.repeat(chips, 2) * sub if cfg.table_rate == 2 else chips

    spc = fs / spec.code_rate_cps
    # each satellite's tables, made once for the channels that share them
    data = {sp.prn: table(codes.code_chips(signal, sp.prn)) for sp in sats}
    pilots = ({sp.prn: table(codes.pilot_code_chips(signal, sp.prn))
               for sp in sats} if pilot else {})
    for ch in range(n_ch - 1):
        sp = sats[ch % len(sats)]
        start = sp.code_delay_s * fs        # chip 0 of the code at d * fs
        off = int(np.ceil(start))
        state = trk.start_channel(
            state, ch, code_freq=spec.code_rate_cps * (
                1 + (sp.doppler_hz + 15.0) / spec.carrier_freq_hz),
            doppler_hz=sp.doppler_hz + 15.0 * (ch % len(sats) - 2),
            sample_offset=off, rem_code_phase=float((off - start) / spc),
            if_freq_hz=(0.0 if slots is None else
                        slots[ch % len(sats)] * spec.fdma_step_hz))
        if pilot:
            tables[ch, 0] = pilots[sp.prn]
            tables[ch, 1] = data[sp.prn]
        else:
            tables[ch] = data[sp.prn]
    sec = None
    if extended:
        if signal == "2S" or slots is not None:
            raise ValueError(f"{signal} has no extended case")
        sec = np.ones((n_ch, cfg.sec_table_len), np.float32)
        if signal == "1C":
            state = trk.set_extension(state, 1, 20, 7)
            state = trk.set_extension(state, 3, 20, 0)
            state = trk.set_secondary(state, sec, 3,
                                      [0, 0, 1, 0, 1, 1, 0, 1, 0, 0], 2)
        elif signal == "1B":
            state = trk.set_extension(state, 1, 5, 2)
            state = trk.set_extension(state, 3, 5, 0)
            state = trk.set_secondary(
                state, sec, 3, codes.pilot_secondary_chips(signal, 17), 0)
        else:
            # the wipe on channel 3, or on the last live channel of fewer
            chips = [int(b) for b in spec.secondary_code]
            wipe = min(3, n_ch - 2)
            state = trk.set_extension(state, 1, len(chips), 3)
            state = trk.set_extension(state, wipe, len(chips), 0)
            state = trk.set_secondary(state, sec, wipe, chips, 0)
    return dict(cfg=cfg, chunk=chunk, state=state, tables=tables, sec=sec)
