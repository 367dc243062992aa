"""Full signal-level simulation scenario: constellation -> IQ samples.

The system-test enabler (reference analog: the external gnss-sim spawned by
``position_test.cc``): picks visible satellites for a receiver truth position,
fits each satellite's transmit-time trajectory to the generator's
(delay, doppler, doppler-rate) model, attaches real LNAV bits, and returns
everything needed to synthesize IQ and to verify the receiver's output
against absolute truth.
"""

from __future__ import annotations

import dataclasses

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

    def generate(self, seed: int = 0, noise: bool = True) -> np.ndarray:
        return generator.generate(self.spec, self.sats, self.fs,
                                  self.duration_s, seed=seed, noise=noise)


def _fit_t_tx(eph, rcv: np.ndarray, t0: float, duration_s: float):
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
        eph, rcv, t0 + t).t_offset_s for t in ts])
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
                          cn0_dbhz: float = 47.0) -> Scenario:
    """Build a static GPS L1 C/A scenario on the almanac constellation
    (the JAX package's builder without its motion, SBAS and almanac-page
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
        a3, a2, a1, a0 = _fit_t_tx(eph, rcv, t0_gps, duration_s)
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
                  fs=fs, ephemerides=ephs, sats=sats, prns=chosen)
    return sc


# 5 satellites (prn, Doppler Hz, code delay s) for tracking_handoff_case
_HANDOFF_SATS = ((3, 1200.0, 1.1e-4), (7, -2400.0, 3.3e-4), (11, 350.0, 6.1e-4),
                 (19, 3900.0, 8.4e-4), (24, -800.0, 2.0e-4))


def tracking_handoff_case(device, *, chunks: int = 1, extended: bool = False,
                          n_channels: int = 6, fs: float = 2.0e6,
                          seed: int = 11) -> dict:
    """An open-loop tracking input: 5 generated GPS L1 C/A satellites
    (45-49 dB-Hz) on ``n_channels`` channels, every channel but the last
    (idle) handed off to satellite ``ch % 5`` slightly off the truth (+15 Hz
    in code rate, 15 Hz steps of Doppler error), over one dispatch of
    ``chunks`` 100 ms chunks plus the halo. ``extended`` switches channels 1
    and 3 to 20-epoch coherent integration and gives channel 3 a 10-chip
    secondary code.

    Returns dict(cfg, chunk [L, 2] float32 numpy, state (the carry on
    ``device``), tables [C, 1023] float32 numpy, sec [C, 32] float32 numpy
    or None)."""
    import dataclasses as _dc

    from gnss_sdr_tpu_torch.models import codes
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    spec = constants.GPS_L1_CA
    cfg = trk.default_config(spec, fs, 100)
    if chunks > 1:
        cl = cfg.chunk_len * chunks
        cfg = _dc.replace(cfg, chunk_len=cl, n_steps=int(
            np.ceil(cl / cfg.samples_per_code)) + 2)
    sats = [generator.SatParams(prn=p, cn0_dbhz=45.0 + i, doppler_hz=d,
                                code_delay_s=cd)
            for i, (p, d, cd) in enumerate(_HANDOFF_SATS)]
    n = cfg.chunk_len + cfg.n_max
    x = generator.generate(spec, sats, fs, n / fs, seed=seed)
    chunk = np.stack([x.real, x.imag], -1).astype(np.float32)
    n_ch = n_channels
    state = trk.init_state(n_ch, cfg.n_taps, device=device)
    tables = np.zeros((n_ch, spec.code_length_chips), np.float32)
    spc = fs / spec.code_rate_cps
    for ch in range(n_ch - 1):
        sp = sats[ch % len(sats)]
        start = sp.code_delay_s * fs        # chip 0 of the code at d * fs
        off = int(np.ceil(start))
        state = trk.start_channel(
            state, ch, code_freq=spec.code_rate_cps * (
                1 + (sp.doppler_hz + 15.0) / spec.carrier_freq_hz),
            doppler_hz=sp.doppler_hz + 15.0 * (ch % len(sats) - 2),
            sample_offset=off, rem_code_phase=float((off - start) / spc))
        tables[ch] = codes.code_chips("1C", sp.prn)
    sec = None
    if extended:
        sec = np.ones((n_ch, cfg.sec_table_len), np.float32)
        state = trk.set_extension(state, 1, 20, 7)
        state = trk.set_extension(state, 3, 20, 0)
        state = trk.set_secondary(state, sec, 3,
                                  [0, 0, 1, 0, 1, 1, 0, 1, 0, 0], 2)
    return dict(cfg=cfg, chunk=chunk, state=state, tables=tables, sec=sec)
