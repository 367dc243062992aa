"""Front-end oscillator calibration from acquisition Doppler residuals.

Port of gnss_sdr_tpu/utils/front_end_cal.py (reference analog: the
``front-end-cal`` utility, ``src/utils/front-end-cal/main.cc``): acquire
every PRN on a short capture with the port's PCPS search on the receiver's
device (``cuda:0`` unless a device is given), predict each detected
satellite's true Doppler from assistance ephemerides and a rough position,
and attribute the common residual to the front-end reference-oscillator
error (reported in Hz at the carrier and in ppm). The fit is host numpy.
Run it as ``python -m gnss_sdr_tpu_torch.utils.front_end_cal -c conf``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.receiver.control import predicted_doppler


@dataclasses.dataclass
class CalResult:
    clock_offset_hz: float      # common Doppler residual at the carrier
    clock_offset_ppm: float
    residuals_hz: dict          # per-PRN after removing the common offset
    n_sats: int


def estimate_oscillator_error(measured_doppler_hz: dict[int, float],
                              ephemerides: dict, rcv_ecef: np.ndarray,
                              t_gps: float,
                              carrier_freq_hz: float = 1_575_420_000.0
                              ) -> CalResult:
    """Fit of the common oscillator offset across acquired satellites:
    measured = predicted + f_osc_error for every SV; the median rejects
    satellites whose acquisition was a false alarm."""
    prns = [p for p in measured_doppler_hz if p in ephemerides]
    if not prns:
        raise ValueError("no overlapping PRNs between measurements and "
                         "assistance")
    predicted = {p: predicted_doppler(ephemerides[p], rcv_ecef, t_gps,
                                      carrier_freq_hz) for p in prns}
    diffs = np.array([measured_doppler_hz[p] - predicted[p] for p in prns])
    offset = float(np.median(diffs))
    resid = {p: float(measured_doppler_hz[p] - predicted[p] - offset)
             for p in prns}
    return CalResult(clock_offset_hz=offset,
                     clock_offset_ppm=offset / carrier_freq_hz * 1e6,
                     residuals_hz=resid, n_sats=len(prns))


@dataclasses.dataclass
class AcqRow:
    prn: int
    detected: bool
    doppler_hz: float
    code_phase: int
    test_cfar: float


def acquire_all_prns(x: np.ndarray, fs: float, *,
                     doppler_max_hz: float = 10_000.0,
                     doppler_step_hz: float = 250.0,
                     threshold_cfar: float = 2.0,
                     noncoherent: int = 2,
                     signal: str = "1C", device=None) -> list[AcqRow]:
    """PCPS sweep over the whole PRN pool on a short capture, on ``device``
    (the acquisition half of the reference front-end-cal app, main.cc:264).
    The Doppler span defaults to +-10 kHz: a several-ppm reference
    oscillator shifts every satellite by kHz."""
    import torch

    from gnss_sdr_tpu_torch import constants
    from gnss_sdr_tpu_torch.models import codes
    from gnss_sdr_tpu_torch.ops import acquisition as acq_ops
    from gnss_sdr_tpu_torch.ops import fft as fft_ops
    from gnss_sdr_tpu_torch.ops import iq
    from gnss_sdr_tpu_torch.receiver.receiver import resolve_device

    dev = resolve_device(device)
    spec = constants.SIGNALS[signal]
    spc = int(round(fs * spec.code_period_s))
    window = spc if fft_ops.is_friendly(spc) else fft_ops.friendly_len(2 * spc)
    stride = spc if window != spc else None
    prns = list(range(1, spec.prn_max + 1))
    reps = []
    for p in prns:
        rep = codes.sample_code(codes.code_chips(signal, p), fs,
                                spec.code_rate_cps, spc,
                                boc_rate=spec.subcarrier_rate_hz)
        if window > len(rep):
            rep = np.concatenate([rep, np.zeros(window - len(rep), rep.dtype)])
        reps.append(np.conj(np.fft.fft(rep)))
    cf = torch.from_numpy(iq.split(np.stack(reps))).to(dev)
    head_len = (noncoherent - 1) * (stride or window) + window
    if len(x) < head_len:
        raise ValueError(f"capture too short: {len(x)} < {head_len} samples")
    dopplers = torch.from_numpy(
        acq_ops.make_doppler_grid(doppler_max_hz, doppler_step_hz)).to(dev)
    spchip = max(1, int(np.ceil(fs / spec.code_rate_cps)))
    head = torch.from_numpy(
        iq.split(np.asarray(x[:head_len], np.complex64))).to(dev)
    res = acq_ops.pcps_search(head, cf, dopplers, fs=fs, samples_per_code=spc,
                              samples_per_chip=spchip, noncoherent=noncoherent,
                              stride=stride)
    cfar = res.test_cfar.cpu().numpy()
    dop = res.doppler_hz.cpu().numpy()
    cp = res.code_phase.cpu().numpy()
    return [AcqRow(prn=p, detected=bool(cfar[i] >= threshold_cfar),
                   doppler_hz=float(dop[i]), code_phase=int(cp[i]),
                   test_cfar=float(cfar[i])) for i, p in enumerate(prns)]


def run_front_end_cal(x: np.ndarray, fs: float, ephemerides: dict,
                      rcv_ecef: np.ndarray, t_gps: float, *,
                      carrier_freq_hz: float = 1_575_420_000.0,
                      doppler_max_hz: float = 10_000.0,
                      doppler_step_hz: float = 250.0,
                      threshold_cfar: float = 2.0, device=None) -> tuple:
    """The full front-end-cal flow: all-PRN acquisition sweep on ``device``,
    then the oscillator-error fit over the detected satellites (reference
    front_end_cal.h:71 / main.cc:264). ``ephemerides`` keyed by bare PRN
    or ("G", prn). Returns (CalResult, [AcqRow])."""
    rows = acquire_all_prns(x, fs, doppler_max_hz=doppler_max_hz,
                            doppler_step_hz=doppler_step_hz,
                            threshold_cfar=threshold_cfar, device=device)
    eph = {(k[1] if isinstance(k, tuple) else k): v
           for k, v in ephemerides.items()
           if not isinstance(k, tuple) or k[0] == "G"}
    measured = {r.prn: r.doppler_hz for r in rows
                if r.detected and r.prn in eph}
    cal = estimate_oscillator_error(measured, eph, np.asarray(rcv_ecef),
                                    t_gps, carrier_freq_hz)
    return cal, rows


def main(argv=None) -> int:
    """CLI: ``python -m gnss_sdr_tpu_torch.utils.front_end_cal -c conf``
    with SignalSource.* keys for the capture and GNSS-SDR.assist_file (a
    JSON checkpoint or rinex2assist output) for ephemerides and the
    reference position / time; ``--platform cpu`` runs the sweep on the
    CPU, else it needs a card."""
    import argparse

    from gnss_sdr_tpu_torch.config import ini
    from gnss_sdr_tpu_torch.receiver import control

    p = argparse.ArgumentParser(prog="front-end-cal")
    p.add_argument("-c", "--config_file", required=True)
    p.add_argument("--seconds", type=float, default=0.05,
                   help="capture length used for the sweep")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    conf = ini.FileConfiguration(args.config_file)
    src = ini.source_from_ini(conf)
    fs = float(conf.property("SignalSource.sampling_frequency", 4_000_000))
    a = control.load_assistance(conf.property("GNSS-SDR.assist_file", ""))
    x = src.read(int(args.seconds * fs))
    tow = a.tow_s if a.tow_s is not None else 0.0
    cal, rows = run_front_end_cal(
        np.asarray(x), fs, a.ephemerides, np.asarray(a.position_ecef), tow,
        doppler_max_hz=float(conf.property("Acquisition_1C.doppler_max",
                                           10_000)),
        doppler_step_hz=float(conf.property("Acquisition_1C.doppler_step",
                                            250)),
        device="cpu" if args.platform == "cpu" else None)
    for r in rows:
        if r.detected:
            print(f"PRN {r.prn:2d}: doppler {r.doppler_hz:+8.1f} Hz "
                  f"cfar {r.test_cfar:.2f}")
    print(f"oscillator error: {cal.clock_offset_hz:+.1f} Hz at L1 "
          f"({cal.clock_offset_ppm:+.3f} ppm) from {cal.n_sats} satellites")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
