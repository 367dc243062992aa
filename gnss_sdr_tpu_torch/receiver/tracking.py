"""Multi-channel tracking engine: one loop step per code epoch, all channels
batched on the leading axis.

Port of gnss_sdr_tpu/receiver/tracking.py (the reference's
``dll_pll_veml_tracking.cc`` redesigned as a scan): ALL channels advance
together through a fixed-size sample chunk; one step = one code epoch per
channel, with loop filters and NCO states carried from step to step. The JAX
``lax.scan`` becomes, on the card, one launch of the fused tracking kernel
K2 per dispatch (:func:`track_chunk_packed` ->
``ops/tracking_kernel.py`` -> ``csrc/tracking.cu``), and, as K2's plain
version and the CPU path, the eager loop :func:`track_chunk`: a Python loop
over ``cfg.n_steps`` steps of tensor ops. The eager loop never synchronises
with the host: no ``.item()``, no boolean-mask indexing, no Python branch on
a tensor value — every per-channel decision is a ``torch.where``, as in the
JAX step.

Variable epoch lengths are handled with a per-channel sample count and a
bounded window (``n_max``); per-channel sample offsets into the chunk live in
the carry and roll over between chunks (the chunk carries a one-epoch halo so
any epoch starting inside it can complete).

Numerics: the JAX reference's compiler turns each division by the constant
sample rate into a multiply by its float32 reciprocal and fuses each
product-plus-sum of the NCO and code-phase updates into one FMA. The port
writes both out (``inv_fs``, :func:`~gnss_sdr_tpu_torch.ops.correlator.fma32`)
so the NCO states round as the reference's do and the integer fields (sample
counts, offsets, whole carrier cycles) follow it exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import cn0 as cn0_ops
from gnss_sdr_tpu_torch.ops import correlator, discriminators, iq
from gnss_sdr_tpu_torch.ops import kalman, tracking_kernel
from gnss_sdr_tpu_torch.ops import loop_filters as lf
from gnss_sdr_tpu_torch.ops.correlator import const, fma32

# channel tracking-state codes (reference: dll_pll_veml_tracking state machine)
STANDBY = 0
PULL_IN = 1
WIDE_TRACK = 2
NARROW_TRACK = 3


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Static tracking parameters for one signal family (the JAX package's
    field set; ``stride_plan`` exists for parity and must stay None: the
    port's correlator is the exact gather)."""

    fs: float                       # conditioned sample rate [sps]
    code_length_chips: int
    code_rate_cps: float
    carrier_freq_hz: float          # nominal RF carrier (for code aiding)
    if_freq_hz: float = 0.0
    chunk_len: int = 0              # samples consumed per chunk (set by engine)
    n_steps: int = 0                # loop steps per chunk
    n_max: int = 0                  # epoch window bound [samples]
    tap_offsets: tuple = (-0.5, 0.0, 0.5)
    table_rate: int = 1             # code-table entries per chip (2 for BOC)
    pll_bw_hz: float = 40.0
    dll_bw_hz: float = 4.0
    fll_bw_hz: float = 10.0
    pll_bw_narrow_hz: float = 15.0
    dll_bw_narrow_hz: float = 2.0
    pull_in_epochs: int = 100       # epochs in PULL_IN before WIDE_TRACK
    wide_epochs: int = 400          # epochs in WIDE_TRACK before NARROW_TRACK
    cn0_min_dbhz: float = 25.0
    carrier_lock_min: float = 0.5
    max_lock_fail: int = 100
    cn0_alpha: float = 0.05
    track_pilot: bool = False
    sec_table_len: int = 32
    carrier_kf: bool = False
    stride_plan: tuple | None = None
    kf_q_phase: float = 1e-6
    kf_q_freq: float = 1.0
    kf_q_rate: float = 100.0

    def __post_init__(self):
        if self.stride_plan is not None:
            raise ValueError("stride_plan: the port has no stride-table "
                             "replica; its correlator is the exact gather")

    @classmethod
    def from_fields(cls, fields: dict) -> "TrackingConfig":
        """Build from a mapping of field names (e.g. the JAX package's
        ``dataclasses.asdict(cfg)``), tuples restored from lists."""
        kw = {f.name: fields[f.name] for f in dataclasses.fields(cls)
              if f.name in fields}
        if "tap_offsets" in kw:
            kw["tap_offsets"] = tuple(float(t) for t in kw["tap_offsets"])
        return cls(**kw)

    @property
    def n_taps(self) -> int:
        """Total correlator taps (main + data prompt when track_pilot)."""
        return len(self.tap_offsets) + (1 if self.track_pilot else 0)

    @property
    def tap_components(self) -> tuple | None:
        if not self.track_pilot:
            return None
        return (0,) * len(self.tap_offsets) + (1,)

    @property
    def prompt_index(self) -> int:
        """Index of the tracked-component prompt tap."""
        return len(self.tap_offsets) // 2

    @property
    def data_prompt_index(self) -> int:
        """Index of the tap carrying the nav-data symbols."""
        return len(self.tap_offsets) if self.track_pilot else self.prompt_index

    @property
    def samples_per_code(self) -> float:
        return self.fs * self.code_length_chips / self.code_rate_cps

    @property
    def code_to_carrier(self) -> float:
        return self.code_rate_cps / self.carrier_freq_hz


def default_config(spec, fs: float, chunk_ms: int, **kw) -> TrackingConfig:
    """Build a TrackingConfig from a SignalSpec (the JAX rule, without the
    stride plan)."""
    spc = fs * spec.code_length_chips / spec.code_rate_cps
    n_max = int(spc) + 64
    code_period_ms = spec.code_length_chips / spec.code_rate_cps * 1e3
    n_steps = int(np.ceil(chunk_ms / code_period_ms)) + 2
    table_rate = 2 if spec.subcarrier_rate_hz > 0 else 1
    taps = (-0.6, -0.15, 0.0, 0.15, 0.6) if spec.subcarrier_rate_hz > 0 \
        else (-0.5, 0.0, 0.5)
    return TrackingConfig(
        fs=fs, code_length_chips=spec.code_length_chips,
        code_rate_cps=spec.code_rate_cps, carrier_freq_hz=spec.carrier_freq_hz,
        chunk_len=int(fs * chunk_ms / 1000), n_steps=n_steps, n_max=n_max,
        tap_offsets=taps, table_rate=table_rate, **kw)


class TrackingState(NamedTuple):
    """Per-channel carry, tensors shaped [C] unless noted."""

    active: torch.Tensor           # bool — channel assigned to a satellite
    state: torch.Tensor            # int32 — STANDBY/PULL_IN/WIDE/NARROW
    sample_offset: torch.Tensor    # int32 — next epoch start within current chunk
    rem_code_phase: torch.Tensor   # float32 — chips, [0, chips/sample)
    code_freq: torch.Tensor        # float32 — chips/s
    carrier_freq: torch.Tensor     # float32 — Hz (IF + Doppler)
    carr_phase_frac: torch.Tensor  # float32 — cycles in [0,1)
    carr_phase_cycles: torch.Tensor  # int32 — accumulated whole cycles
    dll: lf.Loop2State
    pll: lf.Loop3State
    prev_prompt: torch.Tensor      # float32 [C, 2] split-IQ
    cn0: cn0_ops.Cn0State
    epochs_in_state: torch.Tensor  # int32
    epoch_count: torch.Tensor      # int32 — total valid epochs since start
    lock_fail: torch.Tensor        # int32
    loss_of_lock: torch.Tensor     # bool — latched; host reacts
    ext_n: torch.Tensor            # int32 — epochs per coherent accumulation
    ext_anchor: torch.Tensor       # int32 — epoch_count of an accumulation start
    sec_len: torch.Tensor          # int32 — secondary-code length, 0 = none
    sec_anchor: torch.Tensor       # int32 — epoch_count of a secondary-seq start
    acc_corr: torch.Tensor         # float32 [C, K, 2] coherent accumulator
    acc_dt: torch.Tensor           # float32 accumulated integration time
    acc_cnt: torch.Tensor          # int32 epochs in the accumulator
    kf_p: torch.Tensor             # float32 [C, 3, 3] KF covariance
    kf_acc: torch.Tensor           # float32 KF Doppler rate (Hz/s)
    if_freq: torch.Tensor          # float32 per-channel IF (Hz)


class TrackingOutput(NamedTuple):
    """Per-step outputs, tensors shaped [n_steps, C] unless noted."""

    valid: torch.Tensor
    prompt: torch.Tensor           # float32 [n_steps, C, 2] prompt (split-IQ)
    correlators: torch.Tensor      # [n_steps, C, K, 2] float32 (all taps)
    start_offset: torch.Tensor     # int32 epoch start sample within chunk
    n_samples: torch.Tensor        # int32 epoch length
    rem_code_phase: torch.Tensor   # float32 chips at epoch START
    code_freq: torch.Tensor        # float32 chips/s during epoch
    carrier_freq: torch.Tensor     # float32 Hz during epoch
    carr_phase_cycles: torch.Tensor  # int32 at epoch START
    carr_phase_frac: torch.Tensor  # float32 at epoch START
    cn0_dbhz: torch.Tensor
    carrier_lock: torch.Tensor
    state: torch.Tensor
    epoch_index: torch.Tensor      # int32 running epoch number (at epoch START)


_NESTED = {"dll": lf.Loop2State, "pll": lf.Loop3State, "cn0": cn0_ops.Cn0State}
_TORCH_DTYPES = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


def state_from_numpy(mapping, device) -> TrackingState:
    """TrackingState on ``device`` (required: the carry has no default
    device) from a mapping (or NamedTuple) of the JAX
    ``TrackingState`` field names to numpy arrays, with nested ``dll`` /
    ``pll`` / ``cn0`` mappings. dtypes are kept (bool, int32, float32)."""
    def get(m, name):
        return m[name] if isinstance(m, dict) else getattr(m, name)

    def conv(a):
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype not in _TORCH_DTYPES:
            raise TypeError(f"unexpected carry dtype {a.dtype}")
        return torch.from_numpy(a.copy()).to(device)

    fields = {}
    for name in TrackingState._fields:
        v = get(mapping, name)
        if name in _NESTED:
            cls = _NESTED[name]
            fields[name] = cls(*(conv(get(v, f)) for f in cls._fields))
        else:
            fields[name] = conv(v)
    return TrackingState(**fields)


def state_to_numpy(state) -> TrackingState:
    """Writable host (numpy) copy of a carry, same structure; ``state`` is a
    TrackingState or K2's packed carry."""
    def conv(t):
        return t.detach().cpu().numpy().copy()

    state = as_state(state)
    fields = {}
    for name in TrackingState._fields:
        v = getattr(state, name)
        if name in _NESTED:
            fields[name] = type(v)(*(conv(x) for x in v))
        else:
            fields[name] = conv(v)
    return TrackingState(**fields)


def as_state(carry) -> TrackingState:
    """The TrackingState form of a carry: ``carry`` itself, or the unpacked
    form of K2's packed ``[C, W]`` int32 carry (on its device)."""
    if isinstance(carry, torch.Tensor):
        return tracking_kernel.unpack_carry(carry)
    return carry


def _host_edit(state, edit):
    """Apply ``edit`` (which changes a writable numpy carry in place) to a
    carry in either form and return it in the same form on the same device.
    The packed form is pack(edit(unpack)), made on the host: one copy down
    and one up."""
    packed = isinstance(state, torch.Tensor)
    st = state_to_numpy(state.cpu() if packed else state)
    edit(st)
    if packed:
        return tracking_kernel.pack_carry(
            state_from_numpy(st, "cpu")).to(state.device)
    return state_from_numpy(st, _device_of(state))


def _device_of(state: TrackingState):
    return state.active.device


def pack_host_outputs(out: TrackingOutput, loss_of_lock: torch.Tensor):
    """Pack every host-consumed output field into one dense [S, C, 13]
    float32 tensor (one device->host copy per chunk): 9 float columns, the 3
    int32 fields bitcast to float32 (recovered with ``.view(np.int32)``),
    and the [C] loss flags broadcast along the step axis."""
    i32f = torch.stack([out.epoch_index, out.start_offset,
                        out.carr_phase_cycles], dim=-1).view(torch.float32)
    lol = loss_of_lock.to(torch.float32)[None, :, None].expand(
        out.prompt.shape[0], out.prompt.shape[1], 1)
    return torch.cat([
        torch.stack([
            out.prompt[..., 0], out.prompt[..., 1],
            out.rem_code_phase, out.code_freq, out.carrier_freq,
            out.carr_phase_frac, out.cn0_dbhz, out.carrier_lock,
            out.valid.to(torch.float32)], dim=-1),
        i32f, lol], dim=-1)


def unpack_host_outputs(packed: np.ndarray):
    """Host-side inverse of :func:`pack_host_outputs` -> (f32p, i32p, lol):
    [S,C,9] float32, [S,C,3] int32, [C] bool."""
    packed = np.asarray(packed)
    f32p = packed[..., :9]
    i32p = np.ascontiguousarray(packed[..., 9:12]).view(np.int32)
    lol = packed[0, :, 12] > 0.5 if len(packed) else \
        np.zeros(packed.shape[1], bool)
    return f32p, i32p, lol


def init_state(n_channels: int, n_taps: int = 3, *, device) -> TrackingState:
    """Fresh carry for ``n_channels`` idle channels on ``device`` (required)."""
    c = n_channels
    z32 = np.zeros((c,), np.int32)
    zf = np.zeros((c,), np.float32)
    eps = np.full((c,), 1e-12, np.float32)
    host = TrackingState(
        active=np.zeros((c,), bool),
        state=z32.copy(), sample_offset=z32.copy(), rem_code_phase=zf.copy(),
        code_freq=zf.copy(), carrier_freq=zf.copy(), carr_phase_frac=zf.copy(),
        carr_phase_cycles=z32.copy(),
        dll=lf.Loop2State(acc1=zf.copy()),
        pll=lf.Loop3State(acc1=zf.copy(), acc2=zf.copy()),
        prev_prompt=np.zeros((c, 2), np.float32),
        cn0=cn0_ops.Cn0State(zf.copy(), eps.copy(), zf.copy(), eps.copy()),
        epochs_in_state=z32.copy(), epoch_count=z32.copy(),
        lock_fail=z32.copy(),
        loss_of_lock=np.zeros((c,), bool),
        ext_n=np.ones((c,), np.int32),
        ext_anchor=z32.copy(),
        sec_len=z32.copy(),
        sec_anchor=z32.copy(),
        acc_corr=np.zeros((c, n_taps, 2), np.float32),
        acc_dt=zf.copy(),
        acc_cnt=z32.copy(),
        kf_p=kalman.kf_init_cov(c),
        kf_acc=zf.copy(),
        if_freq=zf.copy(),
    )
    return state_from_numpy(host, device)


def start_channel(state: TrackingState, ch: int, *, code_freq: float,
                  doppler_hz: float, sample_offset: int,
                  rem_code_phase: float = 0.0,
                  if_freq_hz: float = 0.0) -> TrackingState:
    """Acq->trk handoff for one channel (reference:
    TrackingInterface::start_tracking, dll_pll state 1 pull-in init). A host
    edit on channel events only (:func:`_host_edit`), on a carry in either
    form."""
    def edit(st):
        st.active[ch] = True
        st.state[ch] = PULL_IN
        st.sample_offset[ch] = sample_offset
        st.rem_code_phase[ch] = rem_code_phase
        st.code_freq[ch] = code_freq
        st.carrier_freq[ch] = if_freq_hz + doppler_hz
        st.if_freq[ch] = if_freq_hz
        st.carr_phase_frac[ch] = 0.0
        st.carr_phase_cycles[ch] = 0
        st.dll.acc1[ch] = 0.0
        st.pll.acc1[ch] = if_freq_hz + doppler_hz
        st.pll.acc2[ch] = 0.0
        st.prev_prompt[ch, :] = 0.0
        st.cn0.ema_abs_i[ch] = 0.0
        st.cn0.ema_p2[ch] = 1e-12
        st.cn0.ema_i2_minus_q2[ch] = 0.0
        st.cn0.ema_i2_plus_q2[ch] = 1e-12
        st.epochs_in_state[ch] = 0
        st.epoch_count[ch] = 0
        st.lock_fail[ch] = 0
        st.loss_of_lock[ch] = False
        st.ext_n[ch] = 1
        st.ext_anchor[ch] = 0
        st.sec_len[ch] = 0
        st.sec_anchor[ch] = 0
        st.acc_corr[ch] = 0.0
        st.acc_dt[ch] = 0.0
        st.acc_cnt[ch] = 0
        st.kf_p[ch] = kalman.kf_init_cov(1)[0]
        st.kf_acc[ch] = 0.0
    return _host_edit(state, edit)


def set_extension(state: TrackingState, ch: int, ext_n: int,
                  anchor_epoch: int) -> TrackingState:
    """Enable ext_n-epoch coherent integration for one channel; accumulation
    windows cover epochs [anchor + k*ext_n, anchor + (k+1)*ext_n)
    (reference: extended-integration handoff after bit sync,
    dll_pll_veml_tracking.cc state 3). Host edit."""
    def edit(st):
        st.ext_n[ch] = max(1, int(ext_n))
        st.ext_anchor[ch] = int(anchor_epoch)
        st.acc_corr[ch] = 0.0
        st.acc_dt[ch] = 0.0
        st.acc_cnt[ch] = 0
        # re-initialize the loop filters at the mode switch (reference:
        # d_carrier_loop_filter.initialize() on the extended handoff)
        st.pll.acc1[ch] = st.carrier_freq[ch]
        st.pll.acc2[ch] = 0.0
        st.dll.acc1[ch] = 0.0
    return _host_edit(state, edit)


def set_secondary(state: TrackingState, sec_tables: np.ndarray, ch: int,
                  chips, anchor_epoch: int) -> TrackingState:
    """Configure secondary-code wipeoff for one channel: ``chips`` (0/1 or
    +-1) repeats with period len(chips), aligned so chip 0 multiplies epochs
    where (epoch - anchor) % len == 0. Mutates the host ``sec_tables[ch]``
    in place (the caller re-uploads it)."""
    chips = np.asarray(chips, np.float32)
    if chips.min() >= 0.0:
        chips = 1.0 - 2.0 * chips          # 0/1 -> +1/-1 chip convention
    sec_tables[ch, :] = 1.0
    sec_tables[ch, : len(chips)] = chips

    def edit(st):
        st.sec_len[ch] = len(chips)
        st.sec_anchor[ch] = int(anchor_epoch)
    return _host_edit(state, edit)


def stop_channel(state: TrackingState, ch: int) -> TrackingState:
    def edit(st):
        st.active[ch] = False
        st.state[ch] = STANDBY
    return _host_edit(state, edit)


def track_chunk_packed(cfg: TrackingConfig, chunk: torch.Tensor,
                       state: TrackingState, code_tables: torch.Tensor,
                       sec_tables: torch.Tensor | None = None,
                       slab: int | None = None):
    """Slice the shared uploaded chunk to this group's slab, run the tracking
    loop and pack the host outputs: (new carry, packed [S, C, 13]).

    ``state`` is a TrackingState or K2's packed ``[C, W]`` int32 carry; the
    new carry comes back in the same form. CUDA tensors go through the fused
    tracking kernel (K2, ops/tracking_kernel.py): one launch for the whole
    dispatch, which writes the packed rows itself; the packed carry stays as
    it is, a TrackingState is packed and unpacked around the launch. CPU
    tensors run the eager loop :func:`track_chunk`, K2's plain version."""
    if slab is not None:
        chunk = chunk[:slab]
    chunk = iq.as_iq2(chunk)
    packed_carry = isinstance(state, torch.Tensor)
    if chunk.device.type == "cuda":
        run = (tracking_kernel.track_chunk_carry if packed_carry
               else tracking_kernel.track_chunk_fused)
        return run(cfg, chunk, state, code_tables, sec_tables)
    if chunk.device.type != "cpu":
        raise ValueError(f"unsupported device {chunk.device}")
    new_state, out = track_chunk(cfg, chunk, as_state(state), code_tables,
                                 sec_tables)
    packed = pack_host_outputs(out, new_state.loss_of_lock)
    if packed_carry:
        return tracking_kernel.pack_carry(new_state), packed
    return new_state, packed


def track_multi_packed(cfgs: tuple, chunk: torch.Tensor, states: tuple,
                       code_tables: tuple, sec_tables: tuple, slabs: tuple):
    """Every signal group's tracking dispatch on one shared chunk, each on
    its slab, with all packed host outputs flattened into one float32
    vector, group after group -> (new carries, flat [sum S*C*13]). On the
    card each group is one K2 launch (:func:`track_chunk_packed`); the host
    splits the vector by the groups' [S, C, 13] sizes."""
    new_states, flats = [], []
    for cfg, st, tab, sec, slab in zip(cfgs, states, code_tables,
                                       sec_tables, slabs):
        ns, packed = track_chunk_packed(cfg, chunk, st, tab, sec, slab=slab)
        new_states.append(ns)
        flats.append(packed.reshape(-1))
    return tuple(new_states), torch.cat(flats)


def track_chunk(cfg: TrackingConfig, chunk: torch.Tensor, state: TrackingState,
                code_tables: torch.Tensor,
                sec_tables: torch.Tensor | None = None,
                correlate=correlator.batch_epoch_correlate
                ) -> tuple[TrackingState, TrackingOutput]:
    """Advance all channels through one chunk of conditioned samples: the
    eager loop, one step of tensor operations per code epoch.

    Args:
      cfg: tracking config.
      chunk: [chunk_len + n_max, 2] float32 split-IQ samples (chunk + halo
        from the next chunk); int8 / packed-nibble uploads are dequantized
        first (ops/iq.py).
      state: carry from the previous chunk.
      code_tables: [C, Lc*table_rate] float32 per-channel code tables
        ([C, 2, Lc*table_rate] when cfg.track_pilot: [pilot, data]).
      sec_tables: [C, S] float32 +-1 secondary-code chips (see
        :func:`set_secondary`); None = no wipeoff anywhere.
      correlate: the multicorrelator, with the arguments of
        :func:`~gnss_sdr_tpu_torch.ops.correlator.batch_epoch_correlate`
        (the default: the plain version on the CPU, K1 on the card) or
        :func:`~gnss_sdr_tpu_torch.ops.correlator.epoch_correlate_plain`.

    Returns (new_state, outputs). ``new_state.sample_offset`` is already
    rebased for the next chunk (offset -= chunk_len). Loop filters update
    once per ``ext_n``-epoch coherent accumulation (ext_n=1: every epoch).

    The steps run under ``torch.inference_mode`` (no autograd bookkeeping:
    about a fifth of a GPS L1 chunk's host time on the CPU, the same
    arithmetic); what they return is copied out of it, so the caller gets
    ordinary tensors it may edit in place.
    """
    with torch.inference_mode():
        st, outputs = _track_chunk(cfg, chunk, state, code_tables,
                                   sec_tables, correlate)
    return _ordinary(st), _ordinary(outputs)


def _ordinary(tree):
    """A NamedTuple of tensors (nested one level, as the carry's loop
    states) with every inference tensor copied into an ordinary one."""
    return type(tree)(*(
        _ordinary(v) if isinstance(v, tuple) else v.clone() for v in tree))


def _track_chunk(cfg, chunk, state, code_tables, sec_tables, correlate):
    """:func:`track_chunk`'s steps."""
    if cfg.carrier_kf:
        raise NotImplementedError("carrier_kf: the Kalman carrier loop is "
                                  "not ported yet")
    chunk = iq.as_iq2(chunk)
    dev = chunk.device
    prompt_i = cfg.prompt_index
    n_ch = code_tables.shape[0]
    # pilot tracking adds the data prompt: one more tap, at offset 0, on
    # the data component of the [C, 2, Lt] tables
    tap_off = tuple(cfg.tap_offsets) + ((0.0,) if cfg.track_pilot else ())
    taps = torch.tensor(tap_off, dtype=torch.float32, device=dev)
    spacing = float(cfg.tap_offsets[prompt_i + 1] - cfg.tap_offsets[prompt_i])
    ch_idx = torch.arange(n_ch, device=dev)
    # every number the step combines with a tensor, as a tensor made once
    # (a Python number is converted on every operation): each rounds to
    # float32 (int32) as the number did, so the bits stay those of the
    # step written with numbers
    f32 = taps
    i32 = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f, one_f = const(0.0, f32), const(1.0, f32)
    zero_i, one_i = const(0, i32), const(1, i32)
    inv_fs = const(float(np.float32(1.0 / cfg.fs)), f32)  # x / fs -> x * inv_fs
    code_len = const(float(cfg.code_length_chips), f32)
    min_cps = const(float(np.float32(1e-6)), f32)
    n_max_f, n_max_i = const(float(cfg.n_max), f32), const(cfg.n_max, i32)
    chunk_len = const(cfg.chunk_len, i32)
    fll_gain = const(float(np.float32(4.0 * cfg.fll_bw_hz)), f32)
    # fma32 widens these float32 values to float64 itself
    code_to_carrier = const(float(np.float32(cfg.code_to_carrier)), f32,
                            torch.float64)
    code_rate = const(float(np.float32(cfg.code_rate_cps)), f32,
                      torch.float64)
    pll_bw = (const(cfg.pll_bw_narrow_hz, f32), const(cfg.pll_bw_hz, f32))
    dll_bw = (const(cfg.dll_bw_narrow_hz, f32), const(cfg.dll_bw_hz, f32))
    cn0_min = const(cfg.cn0_min_dbhz, f32)
    lock_min = const(cfg.carrier_lock_min, f32)
    standby, pull_in = const(STANDBY, i32), const(PULL_IN, i32)
    wide, narrow_code = const(WIDE_TRACK, i32), const(NARROW_TRACK, i32)
    warm_epochs = const(50, i32)
    pull_in_epochs = const(cfg.pull_in_epochs, i32)
    wide_epochs = const(cfg.wide_epochs, i32)
    max_lock_fail = const(cfg.max_lock_fail, i32)

    st = state
    outs = []
    for _ in range(cfg.n_steps):
        cps = st.code_freq * inv_fs
        safe_cps = torch.clamp(cps, min=min_cps)
        # bounded before the int conversion, which saturates in XLA but not
        # on every PyTorch device (an idle channel's 4092 chips / 1e-6 is
        # past int32)
        n_samp = torch.clamp(torch.ceil((code_len - st.rem_code_phase)
                                        / safe_cps), max=n_max_f
                             ).to(torch.int32)
        n_samp = torch.clamp(n_samp, one_i, n_max_i)
        n_samp_f = n_samp.to(torch.float32)
        tracking = st.active & (st.state > standby)
        valid = tracking & (st.sample_offset >= zero_i) & (
            st.sample_offset < chunk_len)

        safe_off = torch.clamp(st.sample_offset, zero_i, chunk_len)
        corr = correlate(
            chunk, safe_off, torch.where(valid, n_samp, zero_i), code_tables,
            st.rem_code_phase, cps, st.carr_phase_frac,
            st.carrier_freq * inv_fs, taps, n_max=cfg.n_max,
            table_rate=cfg.table_rate,
            tap_components=cfg.tap_components)                  # [C, K, 2]

        dt = n_samp_f * inv_fs
        eidx = st.epoch_count

        # ---- secondary-code wipe + coherent accumulation -------------------
        if sec_tables is None:
            corr_w = corr
        else:
            sidx = torch.remainder(eidx - st.sec_anchor,
                                   torch.clamp(st.sec_len, min=one_i))
            chip = torch.where(st.sec_len > zero_i, sec_tables[ch_idx, sidx],
                               one_f)
            corr_w = corr * chip[:, None, None]
        vsel = torch.where(valid, one_f, zero_f)[:, None, None]
        acc = st.acc_corr + corr_w * vsel
        acc_dt = st.acc_dt + torch.where(valid, dt, zero_f)
        acc_cnt = st.acc_cnt + torch.where(valid, one_i, zero_i)
        # loop update fires on the last epoch of each accumulation window
        rel = torch.remainder(eidx - st.ext_anchor,
                              torch.clamp(st.ext_n, min=one_i))
        boundary = valid & (rel == st.ext_n - one_i)
        dt_eff = acc_dt

        prompt2 = acc[:, prompt_i]
        prompt = iq.as_complex(prompt2)
        early = iq.as_complex(acc[:, prompt_i - 1])
        late = iq.as_complex(acc[:, prompt_i + 1])

        # ---- discriminators ------------------------------------------------
        code_err = discriminators.dll_nc_emlp(early, late, spacing)
        phase_err = discriminators.pll_costas(prompt)
        prev_prompt = iq.as_complex(st.prev_prompt)
        freq_err = discriminators.fll_atan2(prev_prompt, prompt, dt_eff)
        # FLL only during pull-in, and only once a previous prompt exists
        has_prev = torch.abs(prev_prompt) > zero_f
        in_pullin = st.state == pull_in
        fll_on = in_pullin & has_prev
        freq_err = torch.where(fll_on, freq_err, zero_f)

        # ---- loop filters (bandwidth scheduled by state) -------------------
        narrow = (st.state == narrow_code) | (st.ext_n > one_i)
        fll_freq = fma32(dt_eff * fll_gain, freq_err, st.carrier_freq)
        new_pll, pll_freq = lf.pll3_update(
            st.pll, phase_err, zero_f, dt_eff,
            torch.where(narrow, *pll_bw), 0.0)
        new_pll = lf.Loop3State(
            acc1=torch.where(in_pullin, fll_freq, new_pll.acc1),
            acc2=torch.where(in_pullin, zero_f, new_pll.acc2))
        new_dll, code_cmd = lf.dll2_update(st.dll, code_err, dt_eff,
                                           torch.where(narrow, *dll_bw))

        new_carrier_freq = torch.where(in_pullin, fll_freq, pll_freq)

        # ---- C/N0 and lock detectors ---------------------------------------
        new_cn0 = cn0_ops.cn0_update(st.cn0, prompt, boundary, cfg.cn0_alpha)
        # moments hold full-window prompts; report with the full coherent
        # time even on mid-window rows (acc_dt there is a partial sum)
        dt_cn0 = st.ext_n.to(torch.float32) * dt
        cn0_est = cn0_ops.cn0_dbhz(new_cn0, dt_cn0)

        doppler = new_carrier_freq - st.if_freq
        new_code_freq = fma32(doppler, code_to_carrier, code_rate) - code_cmd
        lock_metric = cn0_ops.carrier_lock_metric(new_cn0)
        warmed = st.epoch_count > warm_epochs
        fail_now = warmed & (st.state >= wide) & (
            (cn0_est < cn0_min) | (lock_metric < lock_min))
        new_lock_fail = torch.where(
            boundary, torch.where(fail_now, st.lock_fail + one_i,
                                  torch.clamp(st.lock_fail - one_i,
                                              min=zero_i)),
            st.lock_fail)
        loss = st.loss_of_lock | (new_lock_fail > max_lock_fail)

        # ---- state machine --------------------------------------------------
        eis = torch.where(valid, st.epochs_in_state + one_i,
                          st.epochs_in_state)
        promote_wide = in_pullin & (eis >= pull_in_epochs)
        promote_narrow = (st.state == wide) & (eis >= wide_epochs)
        new_state_code = torch.where(
            promote_wide, wide,
            torch.where(promote_narrow, narrow_code, st.state))
        eis = torch.where(promote_wide | promote_narrow, zero_i, eis)

        # ---- NCO phase/offset advance ---------------------------------------
        tot = fma32(st.carrier_freq * inv_fs, n_samp_f, st.carr_phase_frac)
        whole = torch.floor(tot)
        new_frac = tot - whole
        new_cycles = st.carr_phase_cycles + whole.to(torch.int32)
        new_rem = fma32(cps, n_samp_f, st.rem_code_phase) - code_len
        new_rem = torch.clamp(new_rem, min=zero_f)
        new_offset = st.sample_offset + n_samp

        def sel(new, old):
            return torch.where(valid, new, old)

        def bsel(new, old):
            return torch.where(boundary, new, old)

        def bselt(new, old):
            return type(old)(*(bsel(a, b) for a, b in zip(new, old)))

        outs.append(TrackingOutput(
            valid=valid,
            prompt=corr[:, cfg.data_prompt_index],   # raw per-epoch data tap
            correlators=corr,
            start_offset=st.sample_offset,
            n_samples=n_samp,
            rem_code_phase=st.rem_code_phase,
            code_freq=st.code_freq,
            carrier_freq=st.carrier_freq,
            carr_phase_cycles=st.carr_phase_cycles,
            carr_phase_frac=st.carr_phase_frac,
            cn0_dbhz=cn0_est,
            carrier_lock=lock_metric,
            state=st.state,
            epoch_index=st.epoch_count,
        ))

        st = TrackingState(
            active=st.active,
            state=sel(new_state_code, st.state),
            sample_offset=sel(new_offset, st.sample_offset),
            rem_code_phase=sel(new_rem, st.rem_code_phase),
            code_freq=bsel(new_code_freq, st.code_freq),
            carrier_freq=bsel(new_carrier_freq, st.carrier_freq),
            carr_phase_frac=sel(new_frac, st.carr_phase_frac),
            carr_phase_cycles=sel(new_cycles, st.carr_phase_cycles),
            dll=bselt(new_dll, st.dll),
            pll=bselt(new_pll, st.pll),
            prev_prompt=torch.where(boundary[:, None], prompt2, st.prev_prompt),
            cn0=bselt(new_cn0, st.cn0),
            epochs_in_state=sel(eis, st.epochs_in_state),
            epoch_count=sel(st.epoch_count + one_i, st.epoch_count),
            lock_fail=bsel(new_lock_fail, st.lock_fail),
            loss_of_lock=bsel(loss, st.loss_of_lock),
            ext_n=st.ext_n, ext_anchor=st.ext_anchor,
            sec_len=st.sec_len, sec_anchor=st.sec_anchor,
            acc_corr=torch.where(boundary[:, None, None], zero_f, acc),
            acc_dt=torch.where(boundary, zero_f, acc_dt),
            acc_cnt=torch.where(boundary, zero_i, acc_cnt),
            kf_p=st.kf_p,
            kf_acc=st.kf_acc,
            if_freq=st.if_freq,
        )

    st = st._replace(sample_offset=torch.where(
        st.active, st.sample_offset - chunk_len, st.sample_offset))
    outputs = TrackingOutput(*(torch.stack(f) for f in zip(*outs)))
    return st, outputs
