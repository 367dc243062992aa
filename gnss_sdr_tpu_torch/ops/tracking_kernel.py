"""The fused tracking kernel (K2): one launch runs a whole dispatch of the
tracking loop for every channel.

It replaces the JAX package's device program for a chunk, the ``lax.scan``
of ``step`` (gnss_sdr_tpu/receiver/tracking.py:432-632) with the Pallas
multicorrelator (gnss_sdr_tpu/ops/correlator_pallas.py:70) inlined. The
kernel is ``csrc/tracking.cu``; its note says what bounds it on an H100 and
what its design does about that. Its plain version is the eager loop
:func:`gnss_sdr_tpu_torch.receiver.tracking.track_chunk`, which
``track_chunk_packed`` runs for CPU tensors.

The carry crosses into the kernel as one ``[C, W]`` int32 buffer
(:func:`pack_carry`): every ``TrackingState`` field in the order of
``CARRY_FIELDS`` (the ``CarryWord`` enum of the kernel), floats bitcast,
bools as 0/1, ``acc_corr [C, K, 2]`` and ``kf_p [C, 3, 3]`` flattened at the
end. :func:`unpack_carry` is its exact inverse. ``kf_p`` and ``kf_acc`` pass
through the kernel untouched (the Kalman carrier loop is not ported).

The receiver keeps its carry in this packed form on the card between
dispatches, so a dispatch (:func:`track_chunk_carry`) is one launch and two
allocations, with the parameter block cached per configuration and shape;
:func:`track_chunk_fused` takes and returns the ``TrackingState`` form.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import cn0 as cn0_ops
from gnss_sdr_tpu_torch.ops import loop_filters as lf

# launches of the CUDA kernel since the count was last reset: lets a run
# show that its main path went through it
launches = 0

MAX_TAPS = 8
# dynamic shared memory a block may take beside its static scratch
# (csrc/tracking.cu MAX_DYN_SMEM): the window ring and the code table
MAX_SMEM_BYTES = 227 * 1024 - 4096
PACKED_COLS = 13

# carry words in the kernel's order (csrc/tracking.cu enum CarryWord); the
# nested loop-filter and C/N0 states are named "<field>.<subfield>"
CARRY_FIELDS = (
    "active", "state", "sample_offset", "rem_code_phase", "code_freq",
    "carrier_freq", "carr_phase_frac", "carr_phase_cycles", "dll.acc1",
    "pll.acc1", "pll.acc2", "prev_prompt.0", "prev_prompt.1",
    "cn0.ema_abs_i", "cn0.ema_p2", "cn0.ema_i2_minus_q2",
    "cn0.ema_i2_plus_q2", "epochs_in_state", "epoch_count", "lock_fail",
    "loss_of_lock", "ext_n", "ext_anchor", "sec_len", "sec_anchor", "acc_dt",
    "acc_cnt", "kf_acc", "if_freq")


def carry_width(n_taps: int) -> int:
    """Words per channel of the packed carry."""
    return len(CARRY_FIELDS) + 2 * n_taps + 9


def _field(state, name: str) -> torch.Tensor:
    head, _, tail = name.partition(".")
    v = getattr(state, head)
    if head == "prev_prompt":
        return v[:, int(tail)]
    return getattr(v, tail) if tail else v


def _as_words(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"unexpected carry dtype {t.dtype}")
    return t


def pack_carry(state) -> torch.Tensor:
    """Every ``TrackingState`` field in one ``[C, W]`` int32 buffer."""
    n_ch = state.active.shape[0]
    cols = torch.stack([_as_words(_field(state, f).contiguous())
                        for f in CARRY_FIELDS], dim=1)
    return torch.cat([cols,
                      _as_words(state.acc_corr.reshape(n_ch, -1).contiguous()),
                      _as_words(state.kf_p.reshape(n_ch, 9).contiguous())],
                     dim=1)


# the fields that are not float32 (init_state's dtypes)
_BOOL_FIELDS = ("active", "loss_of_lock")
_INT_FIELDS = ("state", "sample_offset", "carr_phase_cycles",
               "epochs_in_state", "epoch_count", "lock_fail", "ext_n",
               "ext_anchor", "sec_len", "sec_anchor", "acc_cnt")


def unpack_carry(buf: torch.Tensor, like=None):
    """The ``TrackingState`` held in ``buf`` (from :func:`pack_carry` or the
    kernel), on ``buf``'s device; the tap count follows from its width and
    must be that of ``like`` (a carry) when one is given. Exact: floats are
    bitcast back; every field is contiguous."""
    from gnss_sdr_tpu_torch.receiver.tracking import TrackingState

    n_ch = buf.shape[0]
    n = len(CARRY_FIELDS)
    n_taps = (buf.shape[1] - n - 9) // 2
    if buf.shape[1] != carry_width(n_taps):
        raise ValueError(f"no tap count gives a carry of width {buf.shape[1]}")
    if like is not None and like.acc_corr.shape[1] != n_taps:
        raise ValueError(f"a carry of width {buf.shape[1]} holds {n_taps} "
                         f"taps, not {like.acc_corr.shape[1]}")
    rows = buf.t().contiguous()                        # [W, C]

    def col(name):
        w = rows[CARRY_FIELDS.index(name)]
        if name in _BOOL_FIELDS:
            return w != 0
        return w if name in _INT_FIELDS else w.view(torch.float32)

    tail = buf[:, n:].contiguous().view(torch.float32)
    return TrackingState(
        active=col("active"), state=col("state"),
        sample_offset=col("sample_offset"),
        rem_code_phase=col("rem_code_phase"), code_freq=col("code_freq"),
        carrier_freq=col("carrier_freq"),
        carr_phase_frac=col("carr_phase_frac"),
        carr_phase_cycles=col("carr_phase_cycles"),
        dll=lf.Loop2State(acc1=col("dll.acc1")),
        pll=lf.Loop3State(acc1=col("pll.acc1"), acc2=col("pll.acc2")),
        prev_prompt=torch.stack([col("prev_prompt.0"), col("prev_prompt.1")],
                                dim=1),
        cn0=cn0_ops.Cn0State(col("cn0.ema_abs_i"), col("cn0.ema_p2"),
                             col("cn0.ema_i2_minus_q2"),
                             col("cn0.ema_i2_plus_q2")),
        epochs_in_state=col("epochs_in_state"),
        epoch_count=col("epoch_count"), lock_fail=col("lock_fail"),
        loss_of_lock=col("loss_of_lock"), ext_n=col("ext_n"),
        ext_anchor=col("ext_anchor"), sec_len=col("sec_len"),
        sec_anchor=col("sec_anchor"),
        acc_corr=tail[:, : 2 * n_taps].reshape(n_ch, n_taps, 2).contiguous(),
        acc_dt=col("acc_dt"), acc_cnt=col("acc_cnt"),
        kf_p=tail[:, 2 * n_taps:].reshape(n_ch, 3, 3).contiguous(),
        kf_acc=col("kf_acc"), if_freq=col("if_freq"))


class _Params(ctypes.Structure):
    """csrc/tracking.cu's TrackParams, field for field."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "n_ch", "n_steps", "n_max", "chunk_len", "length", "table_len",
        "table_rate", "n_taps", "prompt_index", "data_prompt_index",
        "sec_stride", "pull_in_epochs", "wide_epochs", "max_lock_fail",
        "carry_width")]
        + [(n, ctypes.c_float) for n in (
            "inv_fs", "code_len", "min_cps", "emlp_scale", "inv_two_pi",
            "two_pi", "fll_gain", "code_to_carrier", "code_rate", "pll_bw",
            "pll_bw_narrow", "dll_bw", "dll_bw_narrow", "inv_pll_w0",
            "inv_dll_w0", "a3", "b3", "a2", "cn0_alpha", "cn0_min",
            "lock_min", "eps20", "eps12")]
        + [("taps", ctypes.c_float * MAX_TAPS)])


def _f32(x) -> float:
    return float(np.float32(x))


def _recip(x) -> float:
    """1/x as PyTorch's CUDA division by a Python scalar takes it: the
    reciprocal of the float64 scalar, rounded once to float32 (for 0.53 it
    is one ulp from float32(1) / float32(0.53))."""
    return float(np.float32(1.0 / float(x)))


def make_params(cfg, n_ch: int, length: int, table_len: int,
                sec_stride: int) -> _Params:
    """The kernel's static configuration for ``cfg`` (a TrackingConfig) at
    these shapes; each constant rounded as the eager loop rounds it on the
    card."""
    taps = cfg.tap_offsets
    pi = cfg.prompt_index
    two_pi = _f32(2.0 * np.pi)
    p = _Params(
        n_ch=n_ch, n_steps=cfg.n_steps, n_max=cfg.n_max,
        chunk_len=cfg.chunk_len, length=length, table_len=table_len,
        table_rate=cfg.table_rate, n_taps=len(taps), prompt_index=pi,
        data_prompt_index=cfg.data_prompt_index, sec_stride=sec_stride,
        pull_in_epochs=cfg.pull_in_epochs, wide_epochs=cfg.wide_epochs,
        max_lock_fail=cfg.max_lock_fail, carry_width=carry_width(len(taps)),
        inv_fs=_f32(1.0 / cfg.fs), code_len=_f32(cfg.code_length_chips),
        min_cps=_f32(1e-6),
        emlp_scale=_f32(1.0 - float(taps[pi + 1] - taps[pi])),
        inv_two_pi=_recip(two_pi), two_pi=two_pi,
        fll_gain=_f32(4.0 * cfg.fll_bw_hz),
        code_to_carrier=_f32(cfg.code_to_carrier),
        code_rate=_f32(cfg.code_rate_cps), pll_bw=_f32(cfg.pll_bw_hz),
        pll_bw_narrow=_f32(cfg.pll_bw_narrow_hz), dll_bw=_f32(cfg.dll_bw_hz),
        dll_bw_narrow=_f32(cfg.dll_bw_narrow_hz), inv_pll_w0=_recip(0.7845),
        inv_dll_w0=_recip(0.53), a3=_f32(1.1), b3=_f32(2.4), a2=_f32(1.414),
        cn0_alpha=_f32(cfg.cn0_alpha), cn0_min=_f32(cfg.cn0_min_dbhz),
        lock_min=_f32(cfg.carrier_lock_min), eps20=_f32(1e-20),
        eps12=_f32(1e-12))
    for k, t in enumerate(taps):
        p.taps[k] = _f32(t)
    return p


def _check(cfg, chunk, carry, code_tables, sec_tables) -> None:
    """Raise on what the kernel does not take."""
    if cfg.carrier_kf:
        raise NotImplementedError("carrier_kf: the Kalman carrier loop is "
                                  "not ported yet")
    if cfg.track_pilot:
        raise NotImplementedError("track_pilot: pilot tracking is not "
                                  "ported yet")
    tensors = dict(chunk=chunk, carry=carry, code_tables=code_tables)
    if sec_tables is not None:
        tensors["sec_tables"] = sec_tables
    dev = chunk.device
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, chunk on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_taps = len(cfg.tap_offsets)
    if not 3 <= n_taps <= MAX_TAPS:
        raise ValueError(f"3..{MAX_TAPS} taps supported, got {n_taps}")
    if chunk.dtype != torch.float32 or chunk.ndim != 2 or chunk.shape[1] != 2:
        raise ValueError(f"chunk must be float32 [L, 2], got {chunk.dtype} "
                         f"{tuple(chunk.shape)}")
    if chunk.shape[0] < cfg.chunk_len + cfg.n_max:
        raise ValueError(f"chunk of {chunk.shape[0]} samples is shorter than "
                         f"chunk_len + n_max = {cfg.chunk_len + cfg.n_max}")
    if code_tables.dtype != torch.float32 or code_tables.ndim != 2:
        raise ValueError(f"code_tables must be float32 [C, Lt], got "
                         f"{code_tables.dtype} {tuple(code_tables.shape)}")
    n_ch, lt = code_tables.shape
    smem = 2 * cfg.n_max * 8 + lt * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a window ring of 2 x {cfg.n_max} samples and a code "
                         f"table of {lt} entries ({smem} B) exceed the "
                         f"kernel's {MAX_SMEM_BYTES} B of shared memory")
    width = carry_width(n_taps)
    if carry.dtype != torch.int32 or tuple(carry.shape) != (n_ch, width):
        raise ValueError(f"carry must be int32 [{n_ch}, {width}], got "
                         f"{carry.dtype} {tuple(carry.shape)}")
    if sec_tables is not None and (
            sec_tables.dtype != torch.float32 or sec_tables.ndim != 2
            or sec_tables.shape[0] != n_ch or sec_tables.shape[1] < 1):
        raise ValueError(f"sec_tables must be float32 [{n_ch}, S], got "
                         f"{sec_tables.dtype} {tuple(sec_tables.shape)}")


@functools.cache
def _entry():
    """The kernel's C entry point, built and loaded on first use."""
    from gnss_sdr_tpu_torch.utils import cuda_build

    fn = cuda_build.load("tracking").gnss_track_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8
    return fn


# make_params once per configuration and shape (a receiver dispatches with
# at most a few; TrackingConfig is a frozen, hashable dataclass)
cached_params = functools.lru_cache(maxsize=64)(make_params)


def kernel_args(cfg, chunk, carry, code_tables, sec_tables, carry_out,
                packed) -> tuple:
    """The C entry's arguments for checked tensors, writing ``carry_out``
    [C, W] int32 and ``packed`` [S, C, 13] float32 on the current stream.
    The parameter block is kept alive in the tuple."""
    n_ch, lt = code_tables.shape
    params = cached_params(cfg, n_ch, chunk.shape[0], lt,
                           0 if sec_tables is None else sec_tables.shape[1])
    return (params, ctypes.addressof(params), chunk.data_ptr(),
            code_tables.data_ptr(),
            None if sec_tables is None else sec_tables.data_ptr(),
            carry.data_ptr(), carry_out.data_ptr(), packed.data_ptr(),
            torch.cuda.current_stream().cuda_stream)


def launch_kernel(args: tuple) -> None:
    """Launch the kernel once on :func:`kernel_args`; raises on a CUDA
    error. Not counted in ``launches`` (the wrapper counts)."""
    err = _entry()(*args[1:])
    if err != 0:
        raise RuntimeError(f"gnss_track_chunk launch failed: CUDA error "
                           f"{err}")


def track_chunk_carry(cfg, chunk: torch.Tensor, carry: torch.Tensor,
                      code_tables: torch.Tensor,
                      sec_tables: torch.Tensor | None = None):
    """Run one dispatch of the tracking loop in one launch of K2 on the
    packed carry -> (new carry [C, W] int32, packed [S, C, 13]); ``chunk``
    float32 [L, 2] on a CUDA device, L >= chunk_len + n_max. Raises on
    anything else."""
    global launches
    _check(cfg, chunk, carry, code_tables, sec_tables)
    if chunk.device.type != "cuda":
        raise ValueError(f"the fused tracking kernel runs on a CUDA device, "
                         f"not {chunk.device}")
    if chunk.data_ptr() % 8:
        raise ValueError("chunk must be 8-byte aligned (float2 loads)")
    carry_out = torch.empty_like(carry)
    packed = torch.empty((cfg.n_steps, code_tables.shape[0], PACKED_COLS),
                         dtype=torch.float32, device=chunk.device)
    with torch.cuda.device(chunk.device):
        launch_kernel(kernel_args(cfg, chunk, carry, code_tables, sec_tables,
                                  carry_out, packed))
    launches += 1
    return carry_out, packed


def track_chunk_fused(cfg, chunk: torch.Tensor, state,
                      code_tables: torch.Tensor,
                      sec_tables: torch.Tensor | None = None):
    """:func:`track_chunk_carry` on a ``TrackingState`` -> (new_state,
    packed [S, C, 13]): packs the carry before the launch and unpacks it
    after."""
    carry, packed = track_chunk_carry(cfg, chunk, pack_carry(state),
                                      code_tables, sec_tables)
    return unpack_carry(carry, state), packed
