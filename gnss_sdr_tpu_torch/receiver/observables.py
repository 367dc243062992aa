"""Observables: common-epoch pseudorange / carrier-phase / Doppler formation.

Reference analog: ``hybrid_observables_gs`` (``src/algorithms/observables/
gnuradio_blocks/hybrid_observables_gs.cc``): interpolate each channel's
transmit time to a common receiver-clock tick and form
pseudorange = (t_rx - t_tx) * c.

Here the receiver clock ticks are absolute sample counts (the sample counter
*is* the receiver clock, as in the reference's gnss_sdr_sample_counter), and
interpolation uses the tracking engine's per-epoch records: transmit time
advances within an epoch by elapsed samples * code_freq / fs.
Host float64 — exactness of the time bookkeeping matters (SURVEY §7 hard parts).
"""

from __future__ import annotations

import dataclasses

from gnss_sdr_tpu_torch import constants as C


@dataclasses.dataclass
class EpochRecord:
    """One tracking epoch of one channel (host-side copy of TrackingOutput)."""

    abs_start_sample: int
    epoch_index: int
    rem_code_phase: float       # chips at epoch start
    code_freq: float            # chips/s
    carrier_freq: float         # Hz (IF + doppler)
    carr_phase_cycles: int
    carr_phase_frac: float
    cn0_dbhz: float


@dataclasses.dataclass
class ChannelObservable:
    prn: int
    signal: str
    t_tx_sv: float              # transmit time (SV clock, s of week)
    pseudorange_m: float
    # RINEX convention: grows with range (dL/dt = -D), IF ramp stripped —
    # the NEGATED NCO accumulation, exactly as the reference accumulates
    # d_acc_carrier_phase_rad with -= (dll_pll_veml_tracking.cc:1085) so
    # RINEX printers / RTKLIB / PPP consume it directly
    carrier_phase_cycles: float
    doppler_hz: float
    cn0_dbhz: float
    # actual RF carrier of the tracked signal; 0 = look up the nominal in
    # constants.SIGNALS. Distinct from nominal for GLONASS FDMA slots,
    # where the per-slot wavelength decides differential processing
    carrier_freq_hz: float = 0.0


class ObservablesEngine:
    """Forms synchronized observables at a fixed receiver-clock cadence."""

    def __init__(self, fs: float, interval_ms: float = 20.0,
                 rx_time_offset_s: float = 0.085,
                 carrier_smoothing_factor: int = 0):
        self.fs = fs
        self.interval_samples = int(round(fs * interval_ms * 1e-3))
        self.rx_time_offset_s = rx_time_offset_s
        self._rx_origin_tow: float | None = None  # receiver time at sample 0
        self._next_tick: int | None = None
        # Hatch-filter carrier smoothing (reference: Observables
        # enable_carrier_smoothing / smoothing_factor M)
        self.smoothing_m = carrier_smoothing_factor
        self._smooth: dict[tuple, tuple] = {}  # (sig,prn) -> (pr, phase, k)

    def _hatch(self, key, pr: float, carr_range_m: float) -> float:
        """One Hatch-filter step; ``carr_range_m`` is the carrier range in
        meters with the SAME sign as geometry (the caller strips the IF
        ramp and negates the NCO phase: Doppler = -range_rate/lambda)."""
        if self.smoothing_m <= 1:
            return pr
        prev = self._smooth.get(key)
        if prev is None:
            self._smooth[key] = (pr, carr_range_m, 1)
            return pr
        pr_s_prev, carr_prev, k = prev
        dphi = carr_range_m - carr_prev
        # cycle-slip guard: a jump far beyond dynamics resets the filter
        if abs(dphi) > 1000.0:
            self._smooth[key] = (pr, carr_range_m, 1)
            return pr
        k = min(k + 1, self.smoothing_m)
        pr_s = pr / k + (pr_s_prev + dphi) * (k - 1) / k
        self._smooth[key] = (pr_s, carr_range_m, k)
        return pr_s

    def ticks_for_range(self, start_sample: int, end_sample: int) -> list[int]:
        """Receiver-clock tick samples in [start, end)."""
        if self._next_tick is None:
            self._next_tick = ((start_sample // self.interval_samples) + 1) \
                * self.interval_samples
        out = []
        while self._next_tick < end_sample:
            out.append(self._next_tick)
            self._next_tick += self.interval_samples
        return out

    def compute(self, tick_sample: int, channels: list[dict]) -> list[ChannelObservable]:
        """Observables for all locked channels at one tick.

        Each entry of ``channels``: dict with keys
          prn, signal, code_len, code_rate, if_freq,
          record (EpochRecord covering or preceding tick_sample),
          telemetry (object with .have_tow / .transmit_time)
        """
        per_ch = []
        for ch in channels:
            rec: EpochRecord = ch["record"]
            tlm = ch["telemetry"]
            if rec is None or not tlm.have_tow:
                continue
            ds = tick_sample - rec.abs_start_sample
            if ds < 0:
                continue
            chips = rec.rem_code_phase + ds * rec.code_freq / self.fs
            t_tx = tlm.transmit_time(rec.epoch_index, chips,
                                     code_len=ch["code_len"],
                                     code_rate=ch["code_rate"])
            if t_tx is None:
                continue
            nco = (rec.carr_phase_cycles + rec.carr_phase_frac
                   + ds * rec.carrier_freq / self.fs)
            # -> RINEX convention (see ChannelObservable): negate the NCO
            # accumulation (its Doppler is -range_rate/lambda), strip the
            # IF ramp (receiver artifact, constant offset per channel) and
            # repair the Costas 180-deg lock from the telemetry polarity so
            # undifferenced phase ambiguities stay integer (half-cycle flag)
            phase = (-(nco - ch["if_freq"] * tick_sample / self.fs)
                     + getattr(tlm, "half_cycle", 0.0))
            per_ch.append((ch, t_tx, phase))
        if not per_ch:
            return []

        if self._rx_origin_tow is None:
            t_max = max(t for _, t, _ in per_ch)
            self._rx_origin_tow = (round((t_max + self.rx_time_offset_s) * 1e3)
                                   / 1e3 - tick_sample / self.fs)

        t_rx = self._rx_origin_tow + tick_sample / self.fs
        out = []
        for ch, t_tx, phase in per_ch:
            pr = (t_rx - t_tx) * C.SPEED_OF_LIGHT_M_S
            if pr < 0:
                pr += C.SECONDS_PER_WEEK * C.SPEED_OF_LIGHT_M_S
            if self.smoothing_m > 1:
                lam = C.SPEED_OF_LIGHT_M_S / ch.get(
                    "carrier_freq", 1_575_420_000.0)
                # phase is already carrier range in RINEX sign (grows with
                # range, IF-free) — scale to meters for the Hatch projector
                pr = self._hatch((ch["signal"], ch["prn"]), pr, lam * phase)
            out.append(ChannelObservable(
                prn=ch["prn"], signal=ch["signal"], t_tx_sv=t_tx,
                pseudorange_m=pr, carrier_phase_cycles=phase,
                doppler_hz=ch["record"].carrier_freq - ch["if_freq"],
                cn0_dbhz=ch["record"].cn0_dbhz,
                carrier_freq_hz=ch.get("carrier_freq", 0.0)))
        return out

    @property
    def rx_clock_tow(self):
        """Receiver time of sample 0 (s of week, or of day for GLONASS),
        anchored at the first epoch with observables; None before it. The
        multi-source receiver shares it across branches on one time
        scale."""
        return self._rx_origin_tow
