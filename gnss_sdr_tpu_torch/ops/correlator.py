"""Batched multi-tap carrier-wipeoff correlator (the epoch multicorrelator).

Per channel: slice the epoch window out of the sample chunk, wipe off the NCO
carrier, resample K code taps from the channel's chip table, and reduce the K
tap dot products — the contract of the JAX package's
``batch_epoch_correlate`` (gnss_sdr_tpu/ops/correlator.py:26-117) and of its
Pallas kernel ``_kernel`` / ``pallas_epoch_correlate``
(gnss_sdr_tpu/ops/correlator_pallas.py:70,118), which this module replaces.

Two versions of the same function:

- :func:`epoch_correlate_plain` — plain PyTorch: a gather into ``[C, K, N]``
  and a masked reduction in the kernels' summation order, so that it gives
  the kernels' bits. The CPU path, and the yardstick the kernels are held
  against on the card.
- the hand-written CUDA kernel ``csrc/correlator.cu`` (one block per channel,
  the code table staged in shared memory, per-thread partial sums, a
  warp-shuffle reduction; its body is ``csrc/epoch_correlate.cuh``, which
  the fused tracking kernel runs too), launched by
  :func:`batch_epoch_correlate` for CUDA tensors.

What bounds the kernel on an H100: it reads about C*n*8 B of window samples
plus C*Lt*4 B of code tables and writes C*K*8 B; at the GPS L1 tracking
shape (C=8, n~2000, Lt=1023) that is ~0.2 MB, under a tenth of a
microsecond of HBM time, and its FLOPs are fewer still. Neither bounds it:
measured on an H100 it takes about 9 us per launch, nearly the same at C=8
and C=128 (PERF.md). That time is spent inside each block, with one block
per channel on 8 of the card's 132 SMs. Since the fused tracking kernel
runs this body once per epoch inside one launch per dispatch, the receiver
no longer launches this kernel; it stays as the standalone multicorrelator
and the eager loop's card-side correlator.

The JAX package's production path instead uses a rational-stride int8
replica (``batch_epoch_correlate_stride``) because Mosaic could not lower the
table gather; a GPU gathers from shared memory natively, so the port keeps
the exact gather and has no stride tables.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import iq

# launches of the CUDA kernel since the count was last reset (the plain CPU
# path does not count): lets a run show that its main path went through it
launches = 0

# the kernel's fixed limits (csrc/correlator.cu)
MAX_TAPS = 8
# threads of both kernels' blocks (csrc/epoch_correlate.cuh GNSS_THREADS,
# chosen by measurement on an H100, PERF.md): the order in which a block sums
# a window, which the plain version repeats (_block_sum)
BLOCK_THREADS = 512
# dynamic smem beside the reduction's BLOCK_THREADS / 32 rows of 2K floats
MAX_TABLE_BYTES = 48 * 1024 - BLOCK_THREADS // 32 * 2 * MAX_TAPS * 4

_TWO_PI = float(np.float32(2.0 * np.pi))


def const(value, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``dtype`` (default: ``like``'s) on
    ``like``'s device, made once per value, dtype and device. An operation between a tensor and a
    Python number converts the number to a tensor on every call (an
    ``aten::to`` in the eager loop's profile); one between two tensors of
    one dtype does not, and rounds the same: the number is rounded once to
    the dtype either way."""
    return _const(value, dtype or like.dtype, like.device)


@functools.lru_cache(maxsize=1024)
def _const(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add.

    The JAX reference's CPU backend contracts ``c + a * b`` into an FMA, and
    on this path the sum is floored into an integer (a code-table index, a
    sample count), so the port must round it the same way everywhere: the
    product of two float32 is exact in float64, and one float64 add rounded
    to float32 equals fmaf except on a double-rounding tie (about 2^-29 of
    inputs). The CUDA kernels compute the same float64 sum. An argument
    already in float64 (a float32 value widened once, e.g. a constant made
    by :func:`const`) is taken as it is. The product and sum are one
    float64 ``addcmul``: the product of two float32 values is exact in
    float64 however addcmul forms it, so its one rounding is the sum's."""
    return torch.addcmul(_f64(c), _f64(a), _f64(b)).to(torch.float32)


def _f64(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float64 else t.double()


@functools.lru_cache(maxsize=16)
def _sample_axis(n_max: int, device) -> tuple:
    """The window's sample index n < n_max as int32 (the mask and the
    window gather) and float64 (the NCO sums), made once."""
    n_i = torch.arange(n_max, dtype=torch.int32, device=device)
    return n_i, n_i.to(torch.float64)


@functools.lru_cache(maxsize=64)
def _tap_base(n_ch: int, g: int, tap_components: tuple, row: int,
              shift: int, device) -> torch.Tensor:
    """Where channel c's tap k finds its table's entry 0 in the flattened
    [C, G, row] tables, plus ``shift``: int32 [C, K, 1]."""
    c = torch.arange(n_ch, dtype=torch.int32, device=device)[:, None, None]
    k = torch.tensor(tap_components, dtype=torch.int32,
                     device=device)[None, :, None]
    return c * (g * row) + k * row + shift


def epoch_correlate_plain(chunk: torch.Tensor, offsets: torch.Tensor,
                          n_samples: torch.Tensor, code_tables: torch.Tensor,
                          rem_code_phases: torch.Tensor,
                          code_phase_steps: torch.Tensor,
                          carr_phase_fracs: torch.Tensor,
                          carr_phase_steps: torch.Tensor,
                          tap_offsets: torch.Tensor, *, n_max: int,
                          table_rate: int = 1,
                          tap_components: tuple | None = None
                          ) -> torch.Tensor:
    """Plain PyTorch multicorrelator; same arguments as
    :func:`batch_epoch_correlate` with ``chunk`` already float32 [L, 2].
    With ``tap_components`` the tables are [C, G, Lt] and tap k reads
    component ``tap_components[k]`` (the JAX gather path,
    correlator.py:88-92).

    The float32 operations, and their order, are those of the JAX
    ``epoch_correlate`` (correlator.py:62-96) with its products-plus-sums
    fused (:func:`fma32`), so the code index — a floor of a float sum —
    agrees with it bit for bit. The sum over the window follows the
    kernels' block (:func:`_block_sum`) on every device, so on the card the
    whole result equals theirs bit for bit, which lets the tracking kernel
    be held to the eager loop over thousands of dependent steps (a loop of
    PLL / DLL updates turns a last-bit difference in each step's sum into
    more than 1e-4 within 1600 steps), and the CPU path that the tests hold
    against the JAX package sums in that same order."""
    dev = chunk.device
    n_len = chunk.shape[0]
    n_i32, n64 = _sample_axis(n_max, dev)
    # window gather, clamped like a JAX gather; masked past n_samples. I
    # and Q land in planes of their own (the wipe's products run on
    # contiguous rows). Where every window lies inside the chunk (the
    # tracking loop's always: its offsets are clamped to [0, chunk_len])
    # the windows are rows of the chunk's sliding view, one copy;
    # elsewhere each index is clamped.
    lo, hi = torch.aminmax(offsets)
    if bool(lo >= 0) and bool(hi <= n_len - n_max):
        win = torch.index_select(chunk.unfold(0, n_max, 1), 0, offsets)
        wr, wi = win[:, 0], win[:, 1]                              # [C, N]
    else:
        win_idx = (offsets[:, None] + n_i32[None, :]).clamp_(0, n_len - 1)
        flat = chunk.contiguous().view(-1)                         # [2L]
        wr = torch.index_select(flat, 0, win_idx.view(-1).mul_(2))
        wi = torch.index_select(flat, 0, win_idx.view(-1).add_(1))
        wr, wi = wr.view(win_idx.shape), wi.view(win_idx.shape)
    mask = (n_i32[None, :] < n_samples[:, None]).to(chunk.dtype)

    # the carrier and code NCOs' product-sums (fma32) in one pass: in
    # float64 the product of a float32 and an integer below 2^24 is exact,
    # so addcmul's product-sum rounds once, as fma32's sum does
    nco = torch.addcmul(
        torch.stack([carr_phase_fracs, rem_code_phases]).double()[:, :, None],
        torch.stack([carr_phase_steps, code_phase_steps]).double()[:, :, None],
        n64).to(torch.float32)                                     # [2, C, N]
    ph, chips = nco[0], nco[1]
    # remainder(x, 1.0) as x - floor(x): the same bits but the sign of zero
    phase = ph - torch.floor(ph)
    arg = const(_TWO_PI, phase) * phase
    c = torch.cos(arg)
    s = torch.sin(arg)
    xr = (wr * c + wi * s) * mask
    xi = (wi * c - wr * s) * mask

    codes_kn = _code_taps(chips, tap_offsets, code_tables, table_rate,
                          tap_components)                          # [C, K, N]
    # the products, written into _block_sum's zero-padded rows directly
    rows = -(-n_max // BLOCK_THREADS)
    prod = torch.empty((*codes_kn.shape[:2], 2, rows * BLOCK_THREADS),
                       dtype=xr.dtype, device=dev)
    prod[..., n_max:].zero_()
    torch.mul(codes_kn, xr[:, None], out=prod[:, :, 0, :n_max])
    torch.mul(codes_kn, xi[:, None], out=prod[:, :, 1, :n_max])
    return _row_sum(prod.view(*prod.shape[:-1], rows, BLOCK_THREADS))


def _code_taps(chips: torch.Tensor, tap_offsets: torch.Tensor,
               code_tables: torch.Tensor, table_rate: int,
               tap_components: tuple | None) -> torch.Tensor:
    """Each tap's code entry at each sample, [C, K, N]: the table at the
    floor-mod by Lt of floor((chips + tap) * table_rate), rounded in float32
    as the JAX gather path computes it.

    Where every index lies in [-Lt, 2 Lt) (a tracking window always: its
    code phase starts in [0, Lt) and spans one period), the floor-mod is a
    read from the table laid out three times over at index + Lt, the
    plain form of the kernels' compare-and-add (``epoch_wrap_ok``): one
    pass over the indices where the divide-and-floor takes five. Elsewhere
    (a carry outside any tracking window's range, a NaN) it is the exact
    floor-mod."""
    n_ch, lt = code_tables.shape[0], code_tables.shape[-1]
    idx_f = chips[:, None, :] + tap_offsets[None, :, None]
    if table_rate != 1:
        idx_f.mul_(const(float(table_rate), idx_f))
    idx_f.floor_()
    n_taps, dev = idx_f.shape[1], idx_f.device
    comps = tuple(tap_components) if tap_components is not None \
        else (0,) * n_taps
    g = code_tables.numel() // (n_ch * lt)
    # the index is monotonic along the window (a float32 product-sum of a
    # fixed step, floored), so its extremes lie at the window's ends
    lo, hi = torch.aminmax(idx_f[..., :: max(1, idx_f.shape[-1] - 1)])
    if bool(lo >= -lt) and bool(hi < 2 * lt):
        tables = code_tables.reshape(n_ch, g, 1, lt).expand(
            -1, -1, 3, -1).reshape(-1)                            # [C*G*3Lt]
        idx = idx_f.to(torch.int32).add_(_tap_base(n_ch, g, comps, 3 * lt,
                                                   lt, dev))
    else:
        # the floor-mod of the integral float32 floor v, as v - Lt floor(v /
        # Lt): for |v| < 2^24 the rounded quotient is within 1/Lt of the
        # true one and never crosses an integer, so this is exact, as
        # int32's floor-mod is
        ltf = const(float(lt), idx_f)
        idx = (idx_f - ltf * torch.floor(idx_f / ltf)).to(torch.int32)
        idx.add_(_tap_base(n_ch, g, comps, lt, 0, dev))
        tables = code_tables.reshape(-1)                           # [C*G*Lt]
    return torch.index_select(tables, 0, idx.view(-1)).view(idx.shape)


def _block_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum the last axis of ``p`` [..., N] in the order the kernels' thread
    block sums it (csrc/epoch_correlate.cuh): each of BLOCK_THREADS threads
    adds the samples t, t + BLOCK_THREADS, ... in order, a warp-shuffle tree
    halves each warp's 32 sums, then the warps' sums are added in order. So
    the plain version and the kernels give the same bits."""
    n = p.shape[-1]
    rows = -(-n // BLOCK_THREADS)
    p = torch.nn.functional.pad(p, (0, rows * BLOCK_THREADS - n))
    return _row_sum(p.reshape(*p.shape[:-1], rows, BLOCK_THREADS))


def _row_sum(p: torch.Tensor) -> torch.Tensor:
    """:func:`_block_sum` of ``p`` [..., rows, BLOCK_THREADS], the window
    already cut into zero-padded rows of the block's threads."""
    rows = p.unbind(-2)
    acc = rows[0].clone()
    for row in rows[1:]:
        acc.add_(row)
    lanes = acc.reshape(*acc.shape[:-1], BLOCK_THREADS // 32, 32)
    for d in (16, 8, 4, 2, 1):
        lanes = lanes[..., :d] + lanes[..., d:2 * d]
    warps = lanes[..., 0].unbind(-1)
    out = warps[0]
    for w in warps[1:]:
        out = out + w
    return out


def _check(chunk, offsets, n_samples, code_tables, params, tap_offsets,
           n_max: int, table_rate: int, tap_components=None) -> None:
    dev = chunk.device
    tensors = dict(offsets=offsets, n_samples=n_samples,
                   code_tables=code_tables, tap_offsets=tap_offsets, **params)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, chunk on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if chunk.dtype != torch.float32 or chunk.ndim != 2 or chunk.shape[1] != 2:
        raise ValueError(f"chunk must be float32 [L, 2], got {chunk.dtype} "
                         f"{tuple(chunk.shape)}")
    if not chunk.is_contiguous():
        raise ValueError("chunk must be contiguous")
    ndim = 2 if tap_components is None else 3
    if code_tables.dtype != torch.float32 or code_tables.ndim != ndim:
        want = "[C, Lt]" if tap_components is None else "[C, G, Lt]"
        raise ValueError(f"code_tables must be float32 {want}, got "
                         f"{code_tables.dtype} {tuple(code_tables.shape)}")
    n_ch = code_tables.shape[0]
    for name in ("offsets", "n_samples"):
        t = tensors[name]
        if t.dtype != torch.int32 or tuple(t.shape) != (n_ch,):
            raise ValueError(f"{name} must be int32 [{n_ch}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in params.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (n_ch,):
            raise ValueError(f"{name} must be float32 [{n_ch}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tap_offsets.dtype != torch.float32 or tap_offsets.ndim != 1:
        raise ValueError("tap_offsets must be float32 [K]")
    if not 1 <= tap_offsets.shape[0] <= MAX_TAPS:
        raise ValueError(f"1..{MAX_TAPS} taps supported, got "
                         f"{tap_offsets.shape[0]}")
    if n_max < 1 or table_rate < 1:
        raise ValueError("n_max and table_rate must be positive")
    if tap_components is not None and (
            len(tap_components) != tap_offsets.shape[0]
            or not all(0 <= g < code_tables.shape[1] for g in tap_components)):
        raise ValueError(f"tap_components {tap_components} must name one of "
                         f"the {code_tables.shape[1]} table components per "
                         f"tap")


def batch_epoch_correlate(chunk, offsets, n_samples, code_tables,
                          rem_code_phases, code_phase_steps,
                          carr_phase_fracs, carr_phase_steps, tap_offsets,
                          *, n_max: int, table_rate: int = 1,
                          tap_components: tuple | None = None) -> torch.Tensor:
    """Correlate one epoch window per channel against K code taps.

    Shapes: ``chunk`` [L, 2] float32 split-IQ (int8 / packed-nibble uploads
    and complex tensors are converted first, see ops/iq.py);
    ``offsets``/``n_samples`` [C] int32; ``code_tables`` [C, Lt] float32 +/-1
    with Lt = code length * ``table_rate``; ``rem_code_phases`` (chips at the
    window start), ``code_phase_steps`` (chips/sample), ``carr_phase_fracs``
    (cycles), ``carr_phase_steps`` (cycles/sample) [C] float32;
    ``tap_offsets`` [K] float32 chips. Samples n >= n_samples[c] do not
    contribute (n_samples may be 0); ``n_max`` bounds n_samples.
    ``tap_components`` (len K) routes tap k to component
    ``tap_components[k]`` of [C, G, Lt] tables (pilot tracking).

    Returns [C, K, 2] float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (and count the launch), or raise: the kernel
    takes single-component tables only (the Pallas kernel never took
    ``tap_components``; the fused tracking kernel K2 does).
    """
    chunk = iq.as_iq2(chunk)
    params = dict(rem_code_phases=rem_code_phases,
                  code_phase_steps=code_phase_steps,
                  carr_phase_fracs=carr_phase_fracs,
                  carr_phase_steps=carr_phase_steps)
    _check(chunk, offsets, n_samples, code_tables, params, tap_offsets,
           n_max, table_rate, tap_components)
    if chunk.device.type == "cpu":
        return epoch_correlate_plain(
            chunk, offsets, n_samples, code_tables, rem_code_phases,
            code_phase_steps, carr_phase_fracs, carr_phase_steps, tap_offsets,
            n_max=n_max, table_rate=table_rate,
            tap_components=tap_components)
    if chunk.device.type != "cuda":
        raise ValueError(f"unsupported device {chunk.device}")
    if tap_components is not None:
        raise NotImplementedError(
            "tap_components: the standalone multicorrelator kernel takes "
            "single-component tables; pilot tracking runs in the fused "
            "tracking kernel")
    return _launch(chunk, offsets, n_samples, code_tables, params,
                   tap_offsets, n_max, table_rate)


@functools.cache
def _entry():
    """The kernel's C entry point, built and loaded on first use."""
    from gnss_sdr_tpu_torch.utils import cuda_build

    fn = cuda_build.load("correlator").gnss_epoch_correlate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def kernel_args(chunk, offsets, n_samples, code_tables, params, tap_offsets,
                n_max: int, table_rate: int, out) -> tuple:
    """The kernel entry's arguments (csrc/correlator.cu's order) for checked
    tensors, writing into ``out`` [C, K, 2] on the current stream."""
    n_ch, lt = code_tables.shape
    return (chunk.data_ptr(), chunk.shape[0], offsets.data_ptr(),
            n_samples.data_ptr(), n_max, code_tables.data_ptr(), n_ch, lt,
            params["rem_code_phases"].data_ptr(),
            params["code_phase_steps"].data_ptr(),
            params["carr_phase_fracs"].data_ptr(),
            params["carr_phase_steps"].data_ptr(),
            tap_offsets.data_ptr(), tap_offsets.shape[0], table_rate,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)


def launch_kernel(args: tuple) -> None:
    """Launch the kernel once on :func:`kernel_args`; raises on a CUDA error.
    Not counted in ``launches`` (the wrapper counts)."""
    err = _entry()(*args)
    if err != 0:
        raise RuntimeError(f"gnss_epoch_correlate launch failed: CUDA error "
                           f"{err}")


def _launch(chunk, offsets, n_samples, code_tables, params, tap_offsets,
            n_max: int, table_rate: int) -> torch.Tensor:
    global launches
    n_ch, lt = code_tables.shape
    if lt * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"code table of {lt} entries exceeds the kernel's "
                         f"{MAX_TABLE_BYTES} B of shared memory")
    if chunk.data_ptr() % 8:
        raise ValueError("chunk must be 8-byte aligned (float2 loads)")
    out = torch.empty((n_ch, tap_offsets.shape[0], 2), dtype=torch.float32,
                      device=chunk.device)
    with torch.cuda.device(chunk.device):
        launch_kernel(kernel_args(chunk, offsets, n_samples, code_tables,
                                  params, tap_offsets, n_max, table_rate, out))
    launches += 1
    return out
