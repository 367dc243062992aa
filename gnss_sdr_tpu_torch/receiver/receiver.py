"""Top-level receiver: the chunked block pipeline + channel manager.

Port of gnss_sdr_tpu/receiver/receiver.py (the reference's ``GNSSFlowgraph``
+ ``ControlThread``, src/core/receiver/gnss_flowgraph.cc): the receiver
advances chunk by chunk; per chunk it runs
   1. batched PCPS acquisition for idle channels      (device)
   2. the tracking loop for all channels               (device)
   3. telemetry decoding / observables / PVT           (host)
The channel manager mirrors the reference's state machine (idle -> tracking,
reacquire on loss; gnss_flowgraph.cc:1203-1366).

This port covers the GPS L1 C/A, GPS L2 CM, GPS L5I, Galileo E1-B,
Galileo E5a-I, GLONASS L1 / L2 C/A and BeiDou B1I / B3I (MEO / IGSO D1,
GEO D2) receivers, with SBAS L1 channels on the GPS L1 C/A group (MOPS
messages; long-term and fast corrections and the ionospheric grid in the
PVT) and the Kalman carrier loop (``carrier_kf``), alone or as signal
groups of one hybrid receiver
(``signal_plan``, ``group_params``: each group runs its own tracking loop
on the shared stream; BOC(1,1) VEML tracking and E1-C pilot tracking for
Galileo E1; L5Q / E5a-Q pilot tracking and the NH10 / CS20 / NH20 wipe
after symbol sync for the overlaid signals; L2 CM's 20 ms code epochs;
E5a's noncoherent I/Q CAF acquisition; GLONASS FDMA, each satellite
searched and tracked at its frequency slot's IF), with the control plane
(telecommands, assistance, output sinks), the rate conditioner of
``run_file_source``, the Galileo E1 8 ms two-hypothesis acquisition
(``acq_variant="e1_8ms"``), the TCP-connector tracking groups (loop filters
in an external peer, stepped from the host with each epoch's taps from the
epoch multicorrelator on the device: ``receiver/tcp_tracking.py``) and the
per-stage dumps (``dump_dir``, ``io/dumps.py``). Every ``ReceiverConfig``
field of the JAX package exists here; only ``n_mesh_devices`` > 1 (channels
sharded over several devices) raises ``NotImplementedError``.

Device boundary: one upload per dispatch (int8 / packed-nibble / float32, as
``upload_bits`` says, dequantized on the device), one download of the packed
tracking outputs per dispatch at consume time. On the card the tracking
carry stays on the device between dispatches in the packed form the fused
tracking kernel reads and writes; it is unpacked only for host edits on
channel events. The device is a constructor argument: ``Receiver(cfg)`` uses
``cuda:0`` and raises without a card; ``Receiver(cfg, device="cpu")`` runs
the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.models import codes
from gnss_sdr_tpu_torch.ops import acquisition as acq_ops
from gnss_sdr_tpu_torch.ops import fft as fft_ops
from gnss_sdr_tpu_torch.ops import iq
from gnss_sdr_tpu_torch.ops import tracking_kernel
from gnss_sdr_tpu_torch.receiver import control
from gnss_sdr_tpu_torch.receiver import tracking as trk
from gnss_sdr_tpu_torch.receiver.observables import ChannelObservable, EpochRecord, ObservablesEngine
from gnss_sdr_tpu_torch.receiver.pvt import geodesy as _geodesy_mod
from gnss_sdr_tpu_torch.receiver.pvt import solver as pvt_solver
from gnss_sdr_tpu_torch.receiver.telemetry import make_telemetry

log = logging.getLogger("gnss_sdr_tpu_torch")


@dataclasses.dataclass
class ReceiverConfig:
    """The JAX package's receiver configuration, field for field (see
    gnss_sdr_tpu/receiver/receiver.py:45-164 for each field's meaning)."""

    signal: str = "1C"
    fs: float = 2.046e6                # internal (conditioned) sample rate
    if_freq_hz: float = 0.0
    n_channels: int = 8
    prns: tuple = tuple(range(1, 33))  # satellite pool (primary signal)
    signal_plan: tuple = ()
    group_params: tuple = ()
    chunk_ms: int = 100
    upload_int8: bool = True
    upload_bits: int = 0
    dispatch_chunks: int = 1
    pipeline_depth: int = 4
    # acquisition
    acq_doppler_max_hz: float = 5000.0
    acq_doppler_step_hz: float = 250.0
    acq_threshold_cfar: float = 2.0
    acq_noncoherent: int = 2
    acq_bit_transition: bool = False
    acq_two_step: bool = True
    acq_doppler_step2_hz: float = 25.0
    max_in_acquisition: int = 33
    acq_assisted: bool = True
    acq_assisted_doppler_max_hz: float = 600.0
    acq_variant: str = "pcps"
    acq_caf_window_hz: float = 0.0
    acq_both_components: bool = True
    # tracking
    pll_bw_hz: float = 40.0
    dll_bw_hz: float = 4.0
    fll_bw_hz: float = 10.0
    pll_bw_narrow_hz: float = 15.0
    dll_bw_narrow_hz: float = 2.0
    extend_symbols: int = 1
    track_pilot: bool = False
    carrier_kf: bool = False
    tcp_connector: bool = False
    tcp_port_ch0: int = 2060
    glonass_freq_slots: tuple = (
        1, -4, 5, 6, 1, -4, 5, 6, -2, -7, 0, -1,
        -2, -7, 0, -1, 4, -3, 3, 2, 4, -3, 3, 2)
    # observables / pvt
    obs_interval_ms: float = 20.0
    carrier_smoothing_factor: int = 0
    pvt_output_rate_ms: float = 100.0
    pvt_apply_tropo: bool = True
    pvt_apply_iono: bool = True
    pvt_enabled: bool = True
    pvt_apply_sbas: bool = True
    status_period_s: float = 0.0
    dump_dir: str | None = None
    dump_mat: bool = False
    n_mesh_devices: int | None = None


def _check_ported(cfg: ReceiverConfig) -> None:
    """Raise ``NotImplementedError`` for channels sharded over several
    devices (not ported). An ``acq_variant`` other than "e1_8ms" and
    "e5a_caf" runs PCPS, as in the JAX package."""
    if cfg.n_mesh_devices and cfg.n_mesh_devices > 1:
        raise NotImplementedError(
            f"ReceiverConfig.n_mesh_devices={cfg.n_mesh_devices!r} selects a "
            f"feature not ported yet")


def resolve_device(device=None) -> torch.device:
    """The receiver's device: ``device`` if given, else ``cuda:0``; never a
    silent fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return torch.device("cuda", 0)


class Channel:
    """Host-side per-channel bookkeeping (FSM mirror of reference Channel);
    epoch records are stored columnar, one numpy array per field."""

    _REC_FIELDS = ("start", "eidx", "rem", "codef", "carrf",
                   "cyc", "frac", "cn0")

    def __init__(self, ch_id: int, global_id: int):
        self.ch_id = ch_id              # index within its signal group
        self.global_id = global_id      # receiver-wide index
        self.prn: int | None = None
        self.state = "idle"             # idle | tracking
        self.telemetry = None
        self.ext_configured = False     # extended integration engaged
        self._rec: dict | None = None   # columnar epoch history

    def clear_records(self) -> None:
        self._rec = None

    def push_record_block(self, start, eidx, rem, codef, carrf,
                          cyc, frac, cn0) -> None:
        """Append one consumed chunk's epochs, keeping a single row of
        history for ticks that land before the new block."""
        new = dict(start=np.asarray(start, np.int64),
                   eidx=np.asarray(eidx, np.int64),
                   rem=np.asarray(rem, np.float64),
                   codef=np.asarray(codef, np.float64),
                   carrf=np.asarray(carrf, np.float64),
                   cyc=np.asarray(cyc, np.int64),
                   frac=np.asarray(frac, np.float64),
                   cn0=np.asarray(cn0, np.float32))
        old = self._rec
        if old is not None and len(old["start"]):
            new = {k: np.concatenate([old[k][-1:], new[k]])
                   for k in self._REC_FIELDS}
        self._rec = new

    def _materialize(self, i: int) -> EpochRecord:
        r = self._rec
        return EpochRecord(
            abs_start_sample=int(r["start"][i]), epoch_index=int(r["eidx"][i]),
            rem_code_phase=float(r["rem"][i]), code_freq=float(r["codef"][i]),
            carrier_freq=float(r["carrf"][i]),
            carr_phase_cycles=int(r["cyc"][i]),
            carr_phase_frac=float(r["frac"][i]),
            cn0_dbhz=float(r["cn0"][i]))

    def latest_record_before(self, sample: int) -> EpochRecord | None:
        r = self._rec
        if r is None or not len(r["start"]):
            return None
        i = int(np.searchsorted(r["start"], sample, side="right")) - 1
        if i < 0:
            return None
        return self._materialize(i)

    @property
    def records(self) -> list:
        """Materialized record list (tests/status paths, not the hot loop)."""
        if self._rec is None:
            return []
        return [self._materialize(i) for i in range(len(self._rec["start"]))]

    def last_record(self) -> EpochRecord | None:
        r = self._rec
        if r is None or not len(r["start"]):
            return None
        return self._materialize(len(r["start"]) - 1)


class SignalGroup:
    """Per-signal-family receiver state: tracking carry, code tables,
    acquisition pool (reference: one GetChannel_* family per signal). On a
    CUDA device the carry is K2's packed ``[C, W]`` int32 buffer, else a
    TrackingState; the tracking module's functions take either."""

    def __init__(self, cfg: ReceiverConfig, signal: str, n_channels: int,
                 prns: tuple, global_id0: int, device: torch.device):
        self.signal = signal
        self.rx_cfg = cfg
        self.spec = constants.SIGNALS[signal]
        # commensurate sampling trap: fs an integer multiple of the chip
        # rate flattens the ZOH replica's correlation peak (DLL dead zone)
        spc = cfg.fs / self.spec.code_rate_cps
        if abs(spc - round(spc)) < 1e-6 * max(spc, 1.0):
            log.warning(
                "fs=%.0f Hz is an integer multiple of the %s chip rate "
                "(%.0f samples/chip): expect a DLL dead zone with static "
                "pseudorange biases; prefer an incommensurate rate "
                "(e.g. the reference confs use 2.0 MHz for L1 C/A)",
                cfg.fs, signal, spc)
        track_pilot = cfg.track_pilot and codes.has_pilot(signal)
        self.trk_cfg = trk.default_config(
            self.spec, cfg.fs, cfg.chunk_ms,
            if_freq_hz=cfg.if_freq_hz,
            pll_bw_hz=cfg.pll_bw_hz, dll_bw_hz=cfg.dll_bw_hz,
            fll_bw_hz=cfg.fll_bw_hz,
            pll_bw_narrow_hz=cfg.pll_bw_narrow_hz,
            dll_bw_narrow_hz=cfg.dll_bw_narrow_hz,
            track_pilot=track_pilot,
            carrier_kf=cfg.carrier_kf)
        self.channels = [Channel(i, global_id0 + i) for i in range(n_channels)]
        self.trk_state = trk.init_state(n_channels, self.trk_cfg.n_taps,
                                        device=device)
        if device.type == "cuda":
            self.trk_state = tracking_kernel.pack_carry(self.trk_state)
        table_len = self.spec.code_length_chips * self.trk_cfg.table_rate
        shape = ((n_channels, 2, table_len) if track_pilot
                 else (n_channels, table_len))
        self.code_tables = np.zeros(shape, np.float32)
        self.sec_tables = np.ones(
            (n_channels, self.trk_cfg.sec_table_len), np.float32)
        self._sec_dev = None
        self.tables_rev = 0
        self._tables_rev = -1
        self._tables_dev = None
        self.extend_symbols = max(1, int(cfg.extend_symbols))
        self.spc = int(round(cfg.fs * self.spec.code_period_s))
        self._trk_cfg_k: dict[int, trk.TrackingConfig] = {}
        # doubled-FFT transition-tolerant acquisition where data symbols or
        # a secondary code can flip inside a dwell (receiver.py:286-305)
        self.acq_double = bool(cfg.acq_bit_transition
                               or self.spec.secondary_code
                               or self.spec.bit_period_ms * 1e-3
                               <= self.spec.code_period_s + 1e-9)
        self.acq_reps: dict[int, np.ndarray] = {}
        self.acq_reps2: dict[int, tuple] = {}   # e5a_caf replica pairs
        self.acq_pool = list(prns)
        self.acq_backoff: dict[int, int] = {}
        # consecutive failed dwells per PRN: retry intervals grow
        # exponentially (5 chunks doubling to a 300-chunk cap)
        self.acq_fails: dict[int, int] = {}
        self.pinned: dict[int, int] = {}   # local channel -> PRN
        self._vis_rank = None
        # TCP-connector mode: the loops close through external peers; the
        # host-stepped engine replaces the tracking kernel for this group
        # (receiver/tcp_tracking.py; JAX package receiver.py:320-331)
        self.tcp_engine = None
        if cfg.tcp_connector:
            from gnss_sdr_tpu_torch.receiver import tcp_tracking
            self.tcp_engine = tcp_tracking.TcpTrackingEngine(
                spec=self.spec, fs=cfg.fs, n_channels=n_channels,
                n_steps=self.trk_cfg.n_steps, n_max=self.trk_cfg.n_max,
                port_ch0=cfg.tcp_port_ch0,
                table_rate=self.trk_cfg.table_rate,
                cn0_min_dbhz=self.trk_cfg.cn0_min_dbhz,
                carrier_lock_min=self.trk_cfg.carrier_lock_min,
                max_lock_fail=self.trk_cfg.max_lock_fail)

    @property
    def n_max(self) -> int:
        return self.trk_cfg.n_max

    def trk_cfg_for(self, k: int) -> trk.TrackingConfig:
        """Tracking config for a k-chunk dispatch: the loop covers
        k * chunk_len samples in one call. The carry is shape-identical, so
        the engine can alternate k freely."""
        if k <= 1:
            return self.trk_cfg
        if k not in self._trk_cfg_k:
            cl = self.trk_cfg.chunk_len * k
            ns = int(np.ceil(cl / self.trk_cfg.samples_per_code)) + 2
            self._trk_cfg_k[k] = dataclasses.replace(
                self.trk_cfg, chunk_len=cl, n_steps=ns)
        return self._trk_cfg_k[k]

    def _slot_offset_hz(self, prn: int) -> float:
        """A GLONASS satellite's FDMA slot k times the band's step (its
        offset from the band centre, receiver.py:353-367); 0 for CDMA."""
        if self.spec.fdma_step_hz > 0.0:
            slots = self.rx_cfg.glonass_freq_slots
            return slots[(prn - 1) % len(slots)] * self.spec.fdma_step_hz
        return 0.0

    def if_freq_for(self, prn: int) -> float:
        """Per-satellite IF: the receiver's IF plus the slot's offset."""
        return self.rx_cfg.if_freq_hz + self._slot_offset_hz(prn)

    def carrier_freq_for(self, prn: int) -> float:
        """Per-satellite RF carrier (the FDMA slot frequency for GLONASS)."""
        return self.spec.carrier_freq_hz + self._slot_offset_hz(prn)


class Receiver:
    def __init__(self, config: ReceiverConfig, device=None):
        _check_ported(config)
        self.cfg = config
        self.device = resolve_device(device)
        plan = list(config.signal_plan) or [
            (config.signal, config.n_channels, config.prns)]
        self.groups: list[SignalGroup] = []
        gid = 0
        gparams = {sig: dict(items) for sig, items in config.group_params}
        for entry in plan:
            sig, n_ch = entry[0], entry[1]
            prns = entry[2] if len(entry) > 2 and entry[2] else tuple(
                range(1, constants.SIGNALS[sig].prn_max + 1))
            gcfg = (dataclasses.replace(config, **gparams[sig])
                    if sig in gparams else config)
            _check_ported(gcfg)
            self.groups.append(SignalGroup(gcfg, sig, n_ch, prns, gid,
                                           self.device))
            gid += n_ch
        # every group reads its slab of one shared upload: the chunk plus
        # the largest group's halo
        g0 = self.groups[0]
        self.chunk_len = g0.trk_cfg.chunk_len
        self.n_max = max(g.n_max for g in self.groups)

        self.observables = ObservablesEngine(
            config.fs, config.obs_interval_ms,
            carrier_smoothing_factor=config.carrier_smoothing_factor)
        self.ephemerides = {}           # keyed (system, prn)
        self.almanacs = {}              # keyed (system, prn)
        self.iono = None
        self.utc = None
        # assisted-start prior (position + receiver TOW at sample 0) and
        # per-satellite Doppler hints, set by the control plane once ported;
        # until then assisted acquisition runs from the receiver's own fixes
        self.assist_pos = None
        self.assist_tow = None
        self.acq_assist: dict = {}
        self.fixes: list[pvt_solver.PvtSolution] = []
        self.obs_log: list[tuple[int, list[ChannelObservable]]] = []
        self._sample_base = 0           # absolute sample index of chunk start
        # deferred (pends, base, dlen) tuples, oldest first
        self._pending_q: list = []
        self._q_rms = None              # quantizer scale (upload_bits 4/8)
        self._q_rms_next = 0
        self._q_scratch: dict = {}      # per-length quantizer f32 scratch
        # host seconds of the upload's three stages: quantize (or split) on
        # the host, the host->device copy, the dequantization enqueued on
        # the device
        self.upload_seconds = {"quantize": 0.0, "copy": 0.0, "dequant": 0.0}
        # upload_bits=4: I / Q components clipped to the nibble's range,
        # and components quantized, since the quantizer scale was last set
        self.upload_clipped = 0
        self.upload_components = 0
        self._pvt_interval = int(round(
            config.pvt_output_rate_ms / config.obs_interval_ms))
        self._tick_count = 0
        self._chunk_index = 0
        # loop steps dispatched to the tracking engine (each step is one
        # code epoch for all channels), and the dispatches (on the card,
        # one launch of the fused tracking kernel each)
        self.scan_steps = 0
        self.tracking_dispatches = 0
        self._buf = np.zeros(0, np.complex64)
        self._buf_pos = 0
        self._frags: list = []
        self._frag_n = 0
        # output hooks (printers / monitors): called as f(sol) and
        # f(tick_sample, observables) respectively
        self.fix_sinks: list = []
        self.obs_sinks: list = []
        # control plane (telecommands are polled between chunks)
        self.control_queue = control.ControlQueue()
        self.restart_requested = False
        self.stop_requested = False
        self.standby = False
        # the tracing dumps (JAX package receiver.py:462-477), written by
        # close_dumps
        self._dumps = None
        if config.dump_dir:
            from gnss_sdr_tpu_torch.io import dumps as dumps_mod
            d = pathlib.Path(config.dump_dir)
            m = config.dump_mat
            self._dumps = dict(
                tracking=dumps_mod.TrackingDump(d / "tracking.npz", mat=m),
                acquisition=dumps_mod.AcquisitionDump(
                    d / "acquisition.npz", mat=m),
                observables=dumps_mod.ObservablesDump(
                    d / "observables.npz", mat=m),
                pvt=dumps_mod.PvtDump(d / "pvt.npz", mat=m))
            self.obs_sinks.append(
                lambda t, obs: self._dumps["observables"].push_epoch(t, obs))
            self.fix_sinks.append(
                lambda sol: self._dumps["pvt"].push_fix(sol))

    # ------------------------------------------------------------- channels
    @property
    def channels(self) -> list[Channel]:
        """Receiver-wide channel list (all groups, global order)."""
        return [ch for g in self.groups for ch in g.channels]

    @property
    def trk_state(self) -> trk.TrackingState:
        """The primary signal group's tracking carry as a TrackingState
        (the JAX package's field names), on the receiver's device. On the
        card the carry lives packed in K2's buffer and is unpacked here,
        on read only: the dispatch loop never pays for it."""
        return trk.as_state(self.groups[0].trk_state)

    # ------------------------------------------------------------------ acq
    def _acq_window(self, g: SignalGroup) -> tuple[int, int]:
        """(fft_window, dwell_stride): the natural window (1 or 2 code
        periods; one for the E5a CAF search, two for the E1 8 ms search)
        when its length is friendly (ops/fft._split factors <= 512), else
        the next friendly length that keeps every lag in [0, spc) wrap-free
        (spc + the replica's nonzero length) — the JAX package's rule, so
        both search the same windows."""
        spc = g.spc
        variant = g.rx_cfg.acq_variant
        if variant == "e1_8ms":
            base, nonzero = 2 * spc, 2 * spc
        elif variant == "e5a_caf":
            base, nonzero = spc, spc
        else:
            base, nonzero = (2 * spc if g.acq_double else spc), spc
        if fft_ops.is_friendly(base):
            return base, base
        return fft_ops.friendly_len(spc + nonzero), base

    def _spectrum(self, g: SignalGroup, chips: np.ndarray,
                  second: float | None = None) -> np.ndarray:
        """split conj(FFT(one code period's replica of ``chips``)), followed
        by a second period times ``second`` when given, zero-padded to the
        FFT window."""
        rep = codes.sample_code(chips, self.cfg.fs, g.spec.code_rate_cps,
                                g.spc, boc_rate=g.spec.subcarrier_rate_hz)
        if second is not None:
            rep = np.concatenate([rep, second * rep])
        window, _ = self._acq_window(g)
        if window > len(rep):
            rep = np.concatenate([rep, np.zeros(window - len(rep), rep.dtype)])
        return iq.split(np.conj(np.fft.fft(rep)))

    def _code_fft(self, g: SignalGroup, prn: int) -> np.ndarray:
        """The PCPS replica spectrum of ``prn``."""
        if prn not in g.acq_reps:
            g.acq_reps[prn] = self._spectrum(g, codes.code_chips(g.signal,
                                                                 prn))
        return g.acq_reps[prn]

    def _code_fft_pair(self, g: SignalGroup, prn: int) -> tuple:
        """The variant searches' replica spectra. ``e1_8ms``: two-period
        replicas A = [code, code] and B = [code, -code]
        (galileo_pcps_8ms_acquisition_cc.cc:133-140), so a sign flip at the
        period boundary matches one of the two hypotheses. ``e5a_caf``:
        separate data (E5a-I) and pilot (E5a-Q) single-period replicas
        (galileo_e5a_noncoherent_iq_acquisition_caf_cc)."""
        if prn not in g.acq_reps2:
            chips = codes.code_chips(g.signal, prn)
            if g.rx_cfg.acq_variant == "e1_8ms":
                g.acq_reps2[prn] = (self._spectrum(g, chips, 1.0),
                                    self._spectrum(g, chips, -1.0))
            else:
                g.acq_reps2[prn] = (
                    self._spectrum(g, chips),
                    self._spectrum(g, codes.pilot_code_chips(g.signal, prn)))
        return g.acq_reps2[prn]

    def _refine_doppler(self, g: SignalGroup, chunk: np.ndarray, prn: int,
                        delay: int, doppler: float) -> float:
        """Step-two fine Doppler (reference d_step_two analog): correlate K
        consecutive code periods at the coarse Doppler and estimate the
        residual from the prompt phase slope — data-bit insensitive."""
        k = 8
        n = g.spc
        if delay + k * n > len(chunk):
            return doppler
        boc = g.spec.subcarrier_rate_hz
        rep = codes.sample_code(codes.code_chips(g.signal, prn),
                                self.cfg.fs, g.spec.code_rate_cps, n,
                                boc_rate=boc).astype(np.float64)
        wipe = np.exp(-2j * np.pi * doppler * (np.arange(k * n) / self.cfg.fs))
        seg = chunk[delay: delay + k * n].astype(np.complex128) * wipe
        corr = (seg.reshape(k, n) * rep[None, :]).sum(axis=1)
        z = corr[1:] * np.conj(corr[:-1])
        dot = np.real(z)
        dot = np.where(np.abs(dot) < 1e-30, 1e-30, dot)
        t_per = n / self.cfg.fs
        f_res = float(np.mean(np.arctan(np.imag(z) / dot))) / (2 * np.pi * t_per)
        return doppler + f_res

    def _assist_position_time(self):
        """(position, tow) from the latest fix or the assisted-start prior,
        advanced by the stream time processed; (None, None) without one."""
        fix = self.latest_fix()
        if fix is not None:
            return fix.pos_ecef, fix.tow_s
        if self.assist_pos is not None and self.assist_tow is not None:
            return (self.assist_pos,
                    self.assist_tow + self._sample_base / self.cfg.fs)
        return None, None

    def _predicted_dopplers(self, g: SignalGroup,
                            candidates: list[int]) -> list[float] | None:
        """Per-candidate Doppler predictions for assisted (warm)
        acquisition; None unless assistance and a position estimate cover
        ALL candidates (reference pcps_assisted_acquisition)."""
        if not g.rx_cfg.acq_assisted:
            return None
        pos, tow = self._assist_position_time()
        if pos is None and not self.acq_assist:
            return None
        if not self.ephemerides and not self.almanacs \
                and not self.acq_assist:
            return None
        out = []
        for p in candidates:
            hint = self.acq_assist.get((g.spec.system, p))
            if hint is not None:
                dt = 0.0 if tow is None or hint.get("tow_s") is None \
                    else tow - hint["tow_s"]
                if abs(dt) < 600.0:
                    fd = hint["doppler_hz"] \
                        + hint.get("doppler_rate_hz_s", 0.0) * dt
                    out.append(fd + g.if_freq_for(p) - self.cfg.if_freq_hz)
                    continue
            if pos is None:
                return None
            eph = self.ephemerides.get((g.spec.system, p))
            if eph is None:
                alm = self.almanacs.get((g.spec.system, p))
                if alm is None:
                    return None
                eph = alm.to_ephemeris()
            fd = control.predicted_doppler(eph, pos, tow,
                                           g.carrier_freq_for(p))
            out.append(fd + g.if_freq_for(p) - self.cfg.if_freq_hz)
        return out

    def _prioritize_candidates(self, g: SignalGroup,
                               candidates: list) -> list:
        """Order acquisition candidates by predicted elevation when a
        position/time estimate and orbit data exist (reference
        ControlThread::get_visible_sats): visible first, highest first; set
        satellites last; unknown orbits in between. Refreshes every ~100
        chunks."""
        pos, tow = self._assist_position_time()
        if pos is None:
            return candidates
        cache = g._vis_rank
        if cache is None or self._chunk_index - cache[0] >= 100:
            rank: dict = {}
            for p in g.acq_pool:
                eph = self.ephemerides.get((g.spec.system, p))
                if eph is None:
                    alm = self.almanacs.get((g.spec.system, p))
                    if alm is None:
                        continue
                    eph = alm.to_ephemeris()
                try:
                    sat_pos, _ = eph.position_velocity(tow)
                    _, el = _geodesy_mod.az_el(pos, sat_pos)
                except (ValueError, FloatingPointError):
                    continue
                rank[p] = float(el)
            g._vis_rank = cache = (self._chunk_index, rank)
        rank = cache[1]

        def key(p):
            el = rank.get(p)
            if el is None:
                return (1, 0.0)
            if el < np.deg2rad(-5.0):
                return (2, -el)
            return (0, -el)
        return sorted(candidates, key=key)

    def _run_acquisition(self, g: SignalGroup, chunk: np.ndarray,
                         chunk_dev: torch.Tensor) -> None:
        idle = [ch for ch in g.channels if ch.state == "idle"]
        if not idle:
            return
        tracked = {ch.prn for ch in g.channels if ch.state == "tracking"}
        candidates = [p for p in g.acq_pool
                      if p not in tracked
                      and g.acq_backoff.get(p, 0) <= self._chunk_index]
        if len(candidates) > self.cfg.max_in_acquisition:
            candidates = self._prioritize_candidates(g, candidates)
        candidates = candidates[: self.cfg.max_in_acquisition]
        if not candidates:
            return
        variant = g.rx_cfg.acq_variant
        # the E1 8 ms search is one coherent two-period dwell
        nc = 1 if variant == "e1_8ms" else g.rx_cfg.acq_noncoherent
        window, slab = self._acq_window(g)
        head_len = (nc - 1) * slab + window
        if len(chunk) < head_len:
            return
        # slide the dwell start by one code period per chunk so retries
        # de-alias the data-bit phase (receiver.py:719-728)
        n_off = max(1, min(23, (len(chunk) - head_len) // max(g.spc, 1)))
        off = (self._chunk_index % n_off) * g.spc
        head_dev = chunk_dev[off: off + head_len]
        stride = slab if slab != window else None
        dev = self.device
        dopplers = acq_ops.make_doppler_grid(
            g.rx_cfg.acq_doppler_max_hz, g.rx_cfg.acq_doppler_step_hz)
        # CFAR exclusion half-width: CEIL of samples/chip (receiver.py:743-750)
        spchip = max(1, int(np.ceil(self.cfg.fs / g.spec.code_rate_cps)))
        if variant in ("e1_8ms", "e5a_caf"):
            # the unassisted grid, as the JAX package runs these variants
            pairs = [self._code_fft_pair(g, p) for p in candidates]
            cfa, cfb = (torch.from_numpy(np.stack(c)).to(dev)
                        for c in zip(*pairs))
        if variant == "e1_8ms":
            res = acq_ops.pcps_8ms_search(
                head_dev, cfa, cfb, torch.from_numpy(dopplers).to(dev),
                fs=self.cfg.fs, samples_per_code=g.spc,
                samples_per_chip=spchip)
        elif variant == "e5a_caf":
            # data + pilot noncoherently, CAF Doppler re-selection
            caf_half = int(round(g.rx_cfg.acq_caf_window_hz
                                 / (2.0 * g.rx_cfg.acq_doppler_step_hz)))
            res = acq_ops.noncoherent_iq_caf_search(
                head_dev, cfa, cfb, torch.from_numpy(dopplers).to(dev),
                fs=self.cfg.fs, samples_per_code=g.spc,
                samples_per_chip=spchip, noncoherent=nc,
                caf_bins_half=caf_half,
                both_components=g.rx_cfg.acq_both_components, stride=stride)
        else:
            res = self._pcps(g, candidates, head_dev, dopplers, spchip, nc,
                             stride)
        cfar = res.test_cfar.cpu().numpy()
        code_phases = [int(v) for v in res.code_phase.cpu().numpy()]
        doppler_hz = [float(v) for v in res.doppler_hz.cpu().numpy()]
        if self._dumps is not None:
            self._dumps["acquisition"].push_batch(
                g.signal, self._chunk_index, candidates, cfar,
                res.test_max_power.cpu().numpy(), code_phases, doppler_hz,
                res.magnitude.cpu().numpy(), g.rx_cfg.acq_threshold_cfar)
        order = np.argsort(-cfar)
        for idx in order:
            if not idle:
                break
            prn = candidates[int(idx)]
            if cfar[idx] < g.rx_cfg.acq_threshold_cfar:
                fails = self.acq_fails_for(g, prn)
                g.acq_backoff[prn] = self._chunk_index + min(
                    5 << min(fails, 6), 300)
                continue
            # `off` is a code-period multiple: the in-chunk code boundary
            delay = code_phases[int(idx)] + off
            doppler = doppler_hz[int(idx)]
            if g.rx_cfg.acq_two_step and g.spec.fdma_step_hz == 0.0:
                doppler = self._refine_doppler(g, chunk, prn, delay, doppler)
            # honor channel pinning from set_ch_satellite telecommands
            pinned_chs = [c for c in idle if g.pinned.get(c.ch_id) == prn]
            free_chs = [c for c in idle if c.ch_id not in g.pinned]
            pick = pinned_chs[0] if pinned_chs else (free_chs[0] if free_chs
                                                     else None)
            if pick is None:
                continue
            idle.remove(pick)
            self._assign_channel(g, pick, prn, delay, doppler)

    def _pcps(self, g: SignalGroup, candidates: list, head_dev, dopplers,
              spchip: int, nc: int, stride):
        """PCPS over the candidates: per-candidate narrow grids around the
        predicted Dopplers on an assisted warm start (batched into one
        call); under FDMA each candidate's grid centred on its slot IF, the
        Doppler reported as the residual from it (receiver.py:798-812);
        else the full grid."""
        dev = self.device
        cf = torch.from_numpy(
            np.stack([self._code_fft(g, p) for p in candidates])).to(dev)
        if g.spec.fdma_step_hz > 0.0:
            centers = np.array([g.if_freq_for(p) for p in candidates],
                               np.float32)
            grids = centers[:, None] + dopplers[None, :]
            res = acq_ops.pcps_search_grids(
                head_dev, cf, torch.from_numpy(grids).to(dev),
                fs=self.cfg.fs, samples_per_code=g.spc,
                samples_per_chip=spchip, noncoherent=nc, stride=stride)
            return res._replace(doppler_hz=res.doppler_hz.cpu().double()
                                - torch.from_numpy(centers).double())
        predicted = self._predicted_dopplers(g, candidates)
        if predicted is not None:
            grids = np.stack([
                acq_ops.make_doppler_grid(
                    g.rx_cfg.acq_assisted_doppler_max_hz,
                    g.rx_cfg.acq_doppler_step_hz, doppler_center=fd)
                for fd in predicted])
            return acq_ops.pcps_search_grids(
                head_dev, cf, torch.from_numpy(grids).to(dev),
                fs=self.cfg.fs, samples_per_code=g.spc,
                samples_per_chip=spchip, noncoherent=nc, stride=stride)
        return acq_ops.pcps_search(
            head_dev, cf, torch.from_numpy(dopplers).to(dev),
            fs=self.cfg.fs, samples_per_code=g.spc,
            samples_per_chip=spchip, noncoherent=nc, stride=stride)

    def acq_fails_for(self, g: SignalGroup, prn: int) -> int:
        """Count of consecutive failed dwells for this PRN (post-increment:
        returns the count BEFORE this failure)."""
        n = g.acq_fails.get(prn, 0)
        g.acq_fails[prn] = n + 1
        return n

    def _assign_channel(self, g: SignalGroup, ch: Channel, prn: int,
                        delay: int, doppler: float) -> None:
        fc = g.carrier_freq_for(prn)
        code_freq = g.spec.code_rate_cps * (1.0 + doppler / fc)

        def table(chips):
            if g.trk_cfg.table_rate == 2:
                # BOC(1,1): 2 entries per chip, the subcarrier applied
                return np.repeat(chips, 2) * np.tile(
                    [1.0, -1.0], g.spec.code_length_chips).astype(np.float32)
            return chips
        data_table = table(codes.code_chips(g.signal, prn))
        if g.trk_cfg.track_pilot:
            g.code_tables[ch.ch_id, 0] = table(
                codes.pilot_code_chips(g.signal, prn))
            g.code_tables[ch.ch_id, 1] = data_table
        else:
            g.code_tables[ch.ch_id] = data_table
        g.tables_rev += 1
        if g.tcp_engine is not None:
            g.tcp_engine.start_channel(
                ch.ch_id, code_table=g.code_tables[ch.ch_id],
                code_freq=code_freq, doppler_hz=doppler,
                sample_offset=int(delay), if_freq_hz=g.if_freq_for(prn))
        else:
            g.trk_state = trk.start_channel(
                g.trk_state, ch.ch_id, code_freq=code_freq,
                doppler_hz=doppler, sample_offset=int(delay),
                if_freq_hz=g.if_freq_for(prn))
        g.acq_fails.pop(prn, None)
        ch.prn = prn
        ch.state = "tracking"
        ch.telemetry = make_telemetry(g.signal, prn)
        ch.clear_records()
        ch.ext_configured = False
        log.info("ch %d [%s]: PRN %d acquired (delay=%d, doppler=%.0f)",
                 ch.global_id, g.signal, prn, delay, doppler)

    def _drop_channel(self, g: SignalGroup, ch: Channel) -> None:
        log.info("ch %d [%s]: PRN %s loss of lock",
                 ch.global_id, g.signal, ch.prn)
        if g.tcp_engine is not None:
            g.tcp_engine.stop_channel(ch.ch_id)
        g.trk_state = trk.stop_channel(g.trk_state, ch.ch_id)
        # the satellite was demonstrably present: retry on the fast cadence
        g.acq_fails.pop(ch.prn, None)
        g.acq_backoff[ch.prn] = self._chunk_index + 10
        ch.prn = None
        ch.state = "idle"
        ch.telemetry = None
        ch.clear_records()

    # ------------------------------------------------------------ tracking
    def _refresh_tables_dev(self, g: SignalGroup) -> None:
        """Keep the (rarely changing) code and secondary-code tables on the
        device, re-uploaded once per table revision (channel (re)assignment,
        secondary-code anchoring). A group whose signal has no secondary
        code runs the loop without secondary-code tables: its wipe chip
        would be 1.0 on every epoch, a product that changes no bit."""
        if g._tables_rev != g.tables_rev:
            g._tables_dev = torch.from_numpy(g.code_tables).to(self.device)
            g._sec_dev = (torch.from_numpy(g.sec_tables).to(self.device)
                          if g.spec.secondary_code else None)
            g._tables_rev = g.tables_rev

    def _dispatch_tracking(self, g: SignalGroup, chunk_dev: torch.Tensor,
                           k: int = 1):
        """Enqueue this group's tracking loop; returns the packed [S, C, 13]
        device tensor (not yet waited on), or None when no channel tracks.
        A TCP-connector group steps its loops on the host through its peers
        (JAX package receiver.py:1003-1012), each epoch's taps correlated on
        the chunk's device by the epoch multicorrelator, and returns the
        host outputs (f32, i32, loss flags) at once; it launches no fused
        tracking kernel."""
        if not any(ch.state == "tracking" for ch in g.channels):
            return None
        cfg_k = g.trk_cfg_for(k)
        slab = k * self.chunk_len + g.n_max
        if g.tcp_engine is not None:
            return g.tcp_engine.process_chunk(chunk_dev[:slab],
                                              k * self.chunk_len)
        self._refresh_tables_dev(g)
        g.trk_state, packed = trk.track_chunk_packed(
            cfg_k, chunk_dev, g.trk_state, g._tables_dev, g._sec_dev,
            slab=None if chunk_dev.shape[0] == slab else slab)
        self.scan_steps += cfg_k.n_steps
        self.tracking_dispatches += 1
        return packed

    def _finish_tracking(self, g: SignalGroup, pend,
                         sample_base: int | None = None) -> None:
        if isinstance(pend, tuple):       # a TCP group's host outputs
            self._consume_tracking(g, *pend, sample_base)
            return
        packed = pend.cpu().numpy()       # waits for the device work
        f32p, i32p, lol = trk.unpack_host_outputs(packed)
        self._consume_tracking(g, f32p, i32p, lol, sample_base)

    def _consume_tracking(self, g: SignalGroup, f32p, i32p, lol,
                          sample_base: int | None = None) -> None:
        """Feed one chunk's packed tracking outputs into telemetry / records
        and the tracking dump and run the channel watchdogs (the outputs of
        the tracking kernel or of a TCP group's engine). ``sample_base``:
        absolute sample index of the chunk these outputs belong to
        (captured at dispatch)."""
        base = self._sample_base if sample_base is None else sample_base
        prompt = (f32p[..., 0] + 1j * f32p[..., 1]).astype(np.complex64)
        rem = f32p[..., 2]
        codef = f32p[..., 3]
        carrf = f32p[..., 4]
        frac = f32p[..., 5]
        cn0 = f32p[..., 6]
        lock = f32p[..., 7]
        valid = f32p[..., 8] > 0.5
        eidx = i32p[..., 0]
        start = i32p[..., 1]
        cyc = i32p[..., 2]

        for ch in g.channels:
            if ch.state != "tracking":
                continue
            i = ch.ch_id
            v = valid[:, i]
            if v.any():
                ch.telemetry.push(eidx[v, i], prompt[v, i].real)
                ch.push_record_block(
                    base + start[v, i].astype(np.int64), eidx[v, i],
                    rem[v, i], codef[v, i], carrf[v, i], cyc[v, i],
                    frac[v, i], cn0[v, i])
            # after bit sync: extended coherent integration (+ the
            # secondary-code wipe for NH/CS-overlaid signals), anchored at
            # the telemetry's bit boundary (dll_pll_veml_tracking.cc state 3)
            if (g.extend_symbols > 1 and g.tcp_engine is None
                    and not ch.ext_configured
                    and getattr(ch.telemetry, "bit_phase", None) is not None):
                anchor = int(ch.telemetry.bit_phase)
                if g.spec.secondary_code:
                    chips = np.array([int(b) for b in g.spec.secondary_code])
                    g.trk_state = trk.set_secondary(
                        g.trk_state, g.sec_tables, i, chips, anchor)
                    g.tables_rev += 1
                g.trk_state = trk.set_extension(
                    g.trk_state, i, g.extend_symbols, anchor)
                ch.ext_configured = True
                log.info("ch %d [%s]: extended integration %d epochs",
                         ch.global_id, g.signal, g.extend_symbols)
            if v.any() and self._dumps is not None:
                self._dumps["tracking"].push_epochs(
                    ch.global_id, ch.prn, base + start[v, i], eidx[v, i],
                    prompt[v, i], cn0[v, i], carrf[v, i], codef[v, i],
                    rem[v, i], lock[v, i])
            if lol[i] or getattr(ch.telemetry, "sync_failed", False):
                self._drop_channel(g, ch)

    # --------------------------------------------------------- observables
    def _run_observables(self, sample_base: int | None = None,
                         length: int | None = None) -> None:
        base = self._sample_base if sample_base is None else sample_base
        ticks = self.observables.ticks_for_range(
            base, base + (self.chunk_len if length is None else length))
        for t in ticks:
            chans = []
            for g in self.groups:
                # staleness bound for tick extrapolation: at most two
                # (possibly extended) epoch lengths (receiver.py:1167-1174)
                max_ds = 2 * g.spc * max(1, g.extend_symbols)
                for ch in g.channels:
                    if ch.state != "tracking" or ch.telemetry is None:
                        continue
                    rec = ch.latest_record_before(t)
                    if rec is None:
                        continue
                    if t - rec.abs_start_sample > max_ds:
                        continue
                    chans.append(dict(prn=ch.prn, signal=g.signal,
                                      code_len=g.spec.code_length_chips,
                                      code_rate=g.spec.code_rate_cps,
                                      if_freq=g.if_freq_for(ch.prn),
                                      carrier_freq=g.carrier_freq_for(ch.prn),
                                      record=rec, telemetry=ch.telemetry))
            obs = self.observables.compute(t, chans)
            if obs:
                self.obs_log.append((t, obs))
                for sink in self.obs_sinks:
                    sink(t, obs)
            self._tick_count += 1
            if obs and self._tick_count % self._pvt_interval == 0:
                self._run_pvt(obs)

    def _run_pvt(self, obs: list[ChannelObservable]) -> None:
        self.harvest_nav()
        if not self.cfg.pvt_enabled:
            return
        inputs = pvt_solver.combine_iono_free(self.pvt_inputs(obs))
        sbas_lt, sbas_iono = self.sbas_corrections()
        sol = pvt_solver.solve_pvt(
            inputs, self.ephemerides,
            iono=self.iono if self.cfg.pvt_apply_iono else None,
            apply_tropo=self.cfg.pvt_apply_tropo,
            sbas_lt=sbas_lt,
            sbas_iono=sbas_iono if self.cfg.pvt_apply_iono else None)
        if sol.valid:
            self.fixes.append(sol)
            for sink in self.fix_sinks:
                sink(sol)

    def harvest_nav(self) -> None:
        """Pull decoded ephemerides / iono / UTC / almanacs from the
        telemetry channels into the receiver's stores."""
        for g in self.groups:
            for ch in g.channels:
                if ch.state == "tracking" and ch.telemetry is not None:
                    eph = ch.telemetry.ephemeris()
                    if eph is not None:
                        self.ephemerides[(g.spec.system, ch.prn)] = eph
                    asm = ch.telemetry.assembler
                    iono = getattr(asm, "iono", None)
                    if iono is not None and iono.valid:
                        self.iono = iono
                    utc = getattr(asm, "utc", None)
                    if utc is not None and utc.valid:
                        self.utc = utc
                    # an SBAS channel's MT9: the GEO satellite's own state
                    # vector (RINEX 'S' records)
                    geo = getattr(ch.telemetry, "geo_eph", None)
                    if geo is not None:
                        self.ephemerides[("S", ch.prn)] = geo
                    # almanac pages name OTHER satellites: key by their PRN
                    for prn, alm in getattr(asm, "almanacs", {}).items():
                        self.almanacs[(g.spec.system, prn)] = alm

    def sbas_corrections(self):
        """(long-term corrections keyed (system, prn), iono grid) from the
        tracked SBAS channels (reference rtklib sbssatcorr/sbsioncorr
        inputs); (None, None) when SBAS is off or nothing is decoded."""
        if not self.cfg.pvt_apply_sbas:
            return None, None
        lt: dict = {}
        grid = None
        for g in self.groups:
            for ch in g.channels:
                tlm = ch.telemetry
                if ch.state != "tracking" or tlm is None:
                    continue
                mask = getattr(tlm, "prn_mask", None)
                for slot, corr in getattr(tlm, "long_term", {}).items():
                    # MT25 slots are 1-based mask positions
                    if mask and 0 < slot <= len(mask):
                        lt[("G", mask[slot - 1])] = corr
                ig = getattr(tlm, "iono_grid", None)
                if ig is not None and ig.n_points and grid is None:
                    grid = ig
        return (lt or None), grid

    def pvt_inputs(self, obs: list[ChannelObservable]) -> list:
        """Solver inputs for this receiver's observables (SBAS corrections
        + per-group carrier frequencies applied)."""
        # SBAS fast corrections: slot -> PRN via the type-1 mask (DO-229;
        # PR_corrected = PR + PRC), applied to matching GPS observables
        sbas_prc: dict[tuple, float] = {}
        if self.cfg.pvt_apply_sbas:
            for g in self.groups:
                for ch in g.channels:
                    tlm = ch.telemetry
                    if (ch.state == "tracking" and tlm is not None
                            and hasattr(tlm, "fast_corrections")):
                        mask = getattr(tlm, "prn_mask", [])
                        for slot, prc in tlm.fast_corrections.items():
                            if slot < len(mask):
                                sbas_prc[("G", mask[slot])] = prc
        group_by_sig = {g.signal: g for g in self.groups}
        return [pvt_solver.ObsInput(
            prn=o.prn,
            pseudorange_m=o.pseudorange_m + sbas_prc.get(
                (constants.SIGNALS[o.signal].system, o.prn), 0.0),
            doppler_hz=o.doppler_hz,
            carrier_freq_hz=(group_by_sig[o.signal].carrier_freq_for(o.prn)
                             if o.signal in group_by_sig else
                             constants.SIGNALS[o.signal].carrier_freq_hz),
            t_tx_sv=o.t_tx_sv, cn0_dbhz=o.cn0_dbhz,
            system=constants.SIGNALS[o.signal].system) for o in obs]

    # ------------------------------------------------------------- pipeline
    def _upload(self, chunk: np.ndarray) -> torch.Tensor:
        """ONE host->device upload per dispatch in the configured word size
        (int8 split-IQ, packed nibbles or float32), dequantized on the device
        to float32 [L, 2]. The quantizer scale refreshes every ~50 chunks
        (receiver.py:1363-1386). At 4 bits the clip rate is counted
        (``upload_clipped`` of ``upload_components``), logged at debug level
        per upload and at info level each time the scale is set again. The
        host seconds of each stage add up in ``upload_seconds``."""
        bits = self.cfg.upload_bits or (8 if self.cfg.upload_int8 else 32)
        t0 = time.perf_counter()
        if bits in (4, 8):
            if self._q_rms is None or self._chunk_index >= self._q_rms_next:
                if bits == 4 and self.upload_components:
                    log.info("upload_bits=4: %d of %d I/Q components "
                             "(%.4f %%) clipped since the scale was set",
                             self.upload_clipped, self.upload_components,
                             100.0 * self.upload_clipped
                             / self.upload_components)
                self.upload_clipped = self.upload_components = 0
                self._q_rms = iq.measure_rms(chunk)
                self._q_rms_next = self._chunk_index + 50
            scr = self._q_scratch.get(len(chunk))
            if scr is None and len(self._q_scratch) < 4:
                scr = self._q_scratch.setdefault(
                    len(chunk), np.empty((len(chunk), 2), np.float32))
            if bits == 4:
                stats: dict = {}
                host = iq.quantize4(chunk, rms=self._q_rms, scratch=scr,
                                    stats=stats)
                self.upload_clipped += stats["clipped"]
                self.upload_components += 2 * len(chunk)
                log.debug("upload_bits=4: %d of %d I/Q components clipped",
                          stats["clipped"], 2 * len(chunk))
            else:
                host = iq.quantize8(chunk, rms=self._q_rms, scratch=scr)
        else:
            host = iq.split(chunk)
        t1 = time.perf_counter()
        dev = torch.from_numpy(host).to(self.device)
        t2 = time.perf_counter()
        out = iq.as_iq2(dev)
        t3 = time.perf_counter()
        self.upload_seconds["quantize"] += t1 - t0
        self.upload_seconds["copy"] += t2 - t1
        self.upload_seconds["dequant"] += t3 - t2
        return out

    def process(self, samples: np.ndarray, defer: bool = False,
                drain: bool = False) -> None:
        """Feed a contiguous block of conditioned samples (complex64 or
        split-IQ float32 [N, 2]).

        Must be called with blocks of exactly chunk_len except the last.
        ``defer=True`` consumes each dispatch's outputs one dispatch later
        (the device works on chunk n while the host consumes chunk n-1);
        callers then invoke :meth:`flush` at end of stream, as the run loops
        do. ``dispatch_chunks`` > 1 fuses K chunks into one tracking call
        whenever no acquisition work is due, and ``pipeline_depth`` bounds
        the fused quanta in flight (receiver.py:1299-1445).
        """
        samples = np.asarray(samples)
        if samples.dtype.kind != "c":
            samples = iq.combine(samples)
            if samples.base is not None:
                samples = samples.copy()   # own buffered samples
        if len(samples):
            self._frags.append(samples.astype(np.complex64, copy=False))
            self._frag_n += len(samples)
        while True:
            avail = len(self._buf) - self._buf_pos + self._frag_n
            k = self._dispatch_k()
            dlen = k * self.chunk_len
            if avail < dlen + self.n_max:
                # mid-stream, wait for the full quantum; only an explicit
                # end-of-stream drain() processes the tail in single chunks
                if not drain or k == 1 \
                        or avail < self.chunk_len + self.n_max:
                    break
                k, dlen = 1, self.chunk_len
            if len(self._buf) - self._buf_pos < dlen + self.n_max:
                self._buf = np.concatenate(
                    [self._buf[self._buf_pos:]] + self._frags)
                self._buf_pos = 0
                self._frags, self._frag_n = [], 0
            chunk = self._buf[self._buf_pos: self._buf_pos + dlen + self.n_max]
            self._dispatch_commands()
            if not self.standby:
                self._process_chunk(chunk, k, dlen, defer)
            self._buf_pos += dlen
            self._sample_base += dlen
            self._chunk_index += k
            if self.cfg.status_period_s > 0.0:
                period = int(round(self.cfg.status_period_s * self.cfg.fs))
                if (self._sample_base // period
                        != (self._sample_base - dlen) // period):
                    log.info("status @ %.1f s: %s",
                             self._sample_base / self.cfg.fs,
                             self.status_text())

    def _process_chunk(self, chunk: np.ndarray, k: int, dlen: int,
                       defer: bool) -> None:
        """Upload one dispatch's samples, run acquisition, enqueue tracking
        and consume what is due."""
        if not (defer and k > 1):
            # consume the PREVIOUS chunk first, before this chunk's
            # acquisition can reassign a channel the consume drops
            self.flush()
        chunk_dev = self._upload(chunk)
        for g in self.groups:
            self._run_acquisition(g, chunk, chunk_dev)
        # every group's loop is enqueued before the first wait (on the card
        # one K2 launch per tracking group, each on its slab of the upload)
        pends = [(g, self._dispatch_tracking(g, chunk_dev, k))
                 for g in self.groups]
        if defer:
            self._pending_q.append((pends, self._sample_base, dlen))
            if k > 1:
                depth = max(2, int(self.cfg.pipeline_depth))
                while len(self._pending_q) >= depth:
                    self._consume_chunk(*self._pending_q.pop(0))
            else:
                while len(self._pending_q) > 1:
                    self._consume_chunk(*self._pending_q.pop(0))
        else:
            self._consume_chunk(pends, self._sample_base, dlen)

    def _consume_chunk(self, pends, sample_base: int,
                       length: int | None = None) -> None:
        for g, pend in pends:
            if pend is not None:
                self._finish_tracking(g, pend, sample_base)
        self._run_observables(sample_base, length)

    def _dispatch_k(self) -> int:
        """Chunks to fuse into the next dispatch: ``dispatch_chunks``,
        unless acquisition work is due (then single chunks keep the dwell
        cadence at chunk_ms)."""
        k = max(1, int(self.cfg.dispatch_chunks))
        if k == 1 or self.standby:
            return 1
        for g in self.groups:
            if not any(ch.state == "idle" for ch in g.channels):
                continue
            tracked = {ch.prn for ch in g.channels if ch.state == "tracking"}
            if any(p not in tracked
                   and g.acq_backoff.get(p, 0) <= self._chunk_index
                   for p in g.acq_pool):
                return 1
        return k

    def drain(self) -> None:
        """End of stream: process the buffered tail in single chunks and
        consume every deferred dispatch."""
        self.process(np.zeros(0, np.complex64), defer=True, drain=True)
        self.flush()

    def flush(self) -> None:
        """Consume every deferred dispatch still in flight."""
        while self._pending_q:
            self._consume_chunk(*self._pending_q.pop(0))

    # ------------------------------------------------------------- control
    def _dispatch_commands(self) -> None:
        """Apply the telecommands queued since the last chunk (JAX package
        receiver.py:1485-1525)."""
        events = self.control_queue.pop_all()
        if events:
            # telecommands mutate channel/group state; retire any deferred
            # chunk first so drops/restarts see consistent bookkeeping
            self.flush()
        for ev in events:
            log.info("telecommand: %s %s", ev.command, ev.args)
            if ev.command == "standby":
                self.standby = True
                for g in self.groups:
                    for ch in g.channels:
                        if ch.state == "tracking":
                            self._drop_channel(g, ch)
            elif ev.command in ("coldstart", "warmstart", "hotstart"):
                self.standby = False
                if ev.command == "coldstart":
                    self.ephemerides.clear()
                    self.iono = None
                for g in self.groups:
                    for ch in g.channels:
                        if ch.state == "tracking":
                            self._drop_channel(g, ch)
                    g.acq_backoff.clear()
                    g.acq_fails.clear()
            elif ev.command == "reset":
                self.restart_requested = True
            elif ev.command in ("stop", "quit"):
                # keyboard 'q' / stop telecommand: end the run loop without
                # requesting a harness restart
                self.stop_requested = True
            elif ev.command == "set_ch_satellite":
                ch_id, prn = ev.args
                for g in self.groups:
                    for ch in g.channels:
                        if ch.global_id == ch_id:
                            g.pinned[ch.ch_id] = prn
                            if prn not in g.acq_pool:
                                g.acq_pool.append(prn)

    def status_text(self) -> str:
        f = self.latest_fix()
        tracked = ",".join(str(p) for p in self.tracked_prns())
        if f is None:
            return f"NO FIX; tracking PRNs [{tracked}]"
        return (f"FIX lat={np.degrees(f.lat_rad):.6f} "
                f"lon={np.degrees(f.lon_rad):.6f} h={f.height_m:.1f} "
                f"sats={f.n_sats} pdop={f.pdop:.2f}; tracking [{tracked}]")

    def close_dumps(self) -> None:
        """Write the tracing dumps (one npz, and a .mat with ``dump_mat``,
        per stage) under ``dump_dir``."""
        if self._dumps is not None:
            for d in self._dumps.values():
                d.close()

    def close(self) -> None:
        """Release external resources (TCP loop peers, dump files)."""
        for g in self.groups:
            if g.tcp_engine is not None:
                g.tcp_engine.close()
        self.close_dumps()

    def checkpoint(self, path) -> None:
        """Persist assistance data (ephemeris/almanac/iono + last position
        and time) for warm/hot start."""
        fix = self.latest_fix()
        control.save_assistance(
            path, self.ephemerides, self.iono,
            almanacs=self.almanacs,
            position_ecef=(fix.pos_ecef if fix is not None
                           else self.assist_pos),
            tow_s=(fix.tow_s if fix is not None else self.assist_tow))

    def restore(self, path) -> None:
        self.apply_assistance(control.load_assistance(path))

    def apply_assistance(self, a) -> None:
        """Merge an Assistance record (JSON checkpoint, rinex2assist or a
        SUPL A-GNSS fetch) into the warm-start state."""
        self.ephemerides.update(a.ephemerides)
        self.almanacs.update(a.almanacs)
        self.acq_assist.update(getattr(a, "acq", {}) or {})
        if a.iono is not None:
            self.iono = a.iono
        if a.position_ecef is not None:
            self.assist_pos = a.position_ecef
            self.assist_tow = a.tow_s

    def step_source(self, source, cond=None, block_len: int | None = None,
                    input_filter=None) -> bool:
        """Pull ONE block from ``source``, filter and condition it, and
        process it; False once the source is exhausted (JAX package
        receiver.py:1573-1588, the pull-based twin of
        :meth:`run_file_source`)."""
        block = source.read(block_len if block_len is not None
                            else self.chunk_len)
        if input_filter is not None and len(block):
            block = input_filter(block)
        if len(block) < (2 if cond is not None else 1):
            return False
        self.process(cond(block) if cond is not None else block)
        return True

    def run_source(self, source, max_chunks: int | None = None,
                   input_filter=None) -> None:
        """Stream ``source`` (an object with ``read(n)`` returning complex64
        samples at the internal rate) through ``input_filter`` (None, or an
        ``ini.input_filter_from_ini`` stage) and the receiver to its end, a
        stop or a reset request."""
        self._run_pipelined(source, None, self.chunk_len, max_chunks,
                            input_filter)

    def _run_pipelined(self, source, cond, block_len: int,
                       max_chunks: int | None, input_filter=None) -> None:
        """Double-buffered chunk loop: a producer thread reads, filters and
        rate-conditions block k+1 while the receiver processes block k (the
        JAX package's default loop, receiver.py:1609-1656); it stops at the
        source's end, after ``max_chunks`` blocks, or on a stop or reset
        request. The filter sees the source-rate blocks, on the same block
        boundaries as the conditioner."""
        import queue as queue_mod
        import threading

        q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            n = 0
            try:
                while ((max_chunks is None or n < max_chunks)
                       and not stop.is_set()):
                    block = source.read(block_len)
                    if input_filter is not None and len(block):
                        block = input_filter(block)
                    if len(block) < (2 if cond is not None else 1):
                        break
                    q.put(cond(block) if cond is not None else block)
                    n += 1
            finally:
                q.put(None)                  # end-of-stream sentinel

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while not (self.restart_requested or self.stop_requested):
                block = q.get()
                if block is None:
                    break
                self.process(block, defer=True)
            self.drain()
        finally:
            stop.set()
            # drain so a blocked producer can observe the stop flag
            try:
                while q.get_nowait() is not None:
                    pass
            except queue_mod.Empty:
                pass
            t.join(timeout=5.0)

    def run_file_source(self, source, max_chunks: int | None = None,
                        input_filter=None) -> None:
        """Run from a source whose rate may differ from the internal rate:
        ``input_filter`` (notch, pulse blanking, frequency translation,
        beamformer; see ``ini.input_filter_from_ini``) at the source rate,
        then a decimating FIR (integer ratios) or a polyphase fractional
        resampler bridging the rates on the receiver's device (reference
        SignalConditioner = DataTypeAdapter -> InputFilter -> Resampler)."""
        cond, block_len = make_rate_conditioner(source.fs, self.cfg.fs,
                                                self.chunk_len, self.device)
        self._run_pipelined(source, cond, block_len, max_chunks,
                            input_filter)

    # ------------------------------------------------------------- queries
    def tracked_prns(self) -> list[int]:
        return [ch.prn for g in self.groups for ch in g.channels
                if ch.state == "tracking"]

    def latest_fix(self):
        return self.fixes[-1] if self.fixes else None


def make_rate_conditioner(source_fs: float, target_fs: float,
                          chunk_len: int, device=None):
    """Rate-bridging conditioner from the source rate to the internal rate
    (JAX package receiver.py:1696-1728), running on ``device``.

    Returns ``(cond, block_len)``: ``cond`` maps a source-rate block to a
    target-rate split-IQ block (None when the rates already match) and
    ``block_len`` is the source-rate read size that conditions to ~one
    chunk."""
    from gnss_sdr_tpu_torch.ops.fir import (StreamingFir,
                                            StreamingFractionalResampler,
                                            design_lowpass)

    ratio = source_fs / target_fs
    if abs(ratio - 1.0) < 1e-9:
        return None, chunk_len
    dev = resolve_device(device)
    decim = int(round(ratio))
    if abs(ratio - decim) < 1e-9:
        taps = design_lowpass(decim * 16 + 1, 0.8 / decim)
        return StreamingFir(taps, decim=decim, device=dev), chunk_len * decim
    if ratio > 1.0:
        # downsampling: anti-alias at the output Nyquist, then
        # fractional interpolation
        lp = StreamingFir(design_lowpass(33, 0.8 / ratio), device=dev)
        frac = StreamingFractionalResampler(source_fs, target_fs, device=dev)
        return (lambda x: frac(lp(x))), int(round(chunk_len * ratio))
    # upsampling: no anti-alias filter needed (the input band is
    # already inside the output Nyquist)
    frac = StreamingFractionalResampler(source_fs, target_fs, device=dev)
    return frac, max(2, int(round(chunk_len * ratio)))
