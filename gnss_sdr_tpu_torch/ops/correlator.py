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


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add.

    The JAX reference's CPU backend contracts ``c + a * b`` into an FMA, and
    on this path the sum is floored into an integer (a code-table index, a
    sample count), so the port must round it the same way everywhere: the
    product of two float32 is exact in float64, and one float64 add rounded
    to float32 equals fmaf except on a double-rounding tie (about 2^-29 of
    inputs). The CUDA kernels compute the same float64 sum."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def epoch_correlate_plain(chunk: torch.Tensor, offsets: torch.Tensor,
                          n_samples: torch.Tensor, code_tables: torch.Tensor,
                          rem_code_phases: torch.Tensor,
                          code_phase_steps: torch.Tensor,
                          carr_phase_fracs: torch.Tensor,
                          carr_phase_steps: torch.Tensor,
                          tap_offsets: torch.Tensor, *, n_max: int,
                          table_rate: int = 1) -> torch.Tensor:
    """Plain PyTorch multicorrelator; same arguments as
    :func:`batch_epoch_correlate` with ``chunk`` already float32 [L, 2].

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
    n_i = torch.arange(n_max, dtype=torch.int32, device=dev)
    n = n_i.to(torch.float32)                                      # [N]
    # window gather, clamped like a JAX gather; masked past n_samples
    win_idx = (offsets[:, None] + n_i[None, :]).clamp(0, n_len - 1)
    win = chunk[win_idx.long()]                                    # [C, N, 2]
    mask = (n[None, :] < n_samples.to(torch.float32)[:, None]).to(torch.float32)

    phase = torch.remainder(
        fma32(carr_phase_steps[:, None], n[None, :], carr_phase_fracs[:, None]),
        1.0)
    c = torch.cos(_TWO_PI * phase)
    s = torch.sin(_TWO_PI * phase)
    wr = win[..., 0]
    wi = win[..., 1]
    xr = (wr * c + wi * s) * mask
    xi = (wi * c - wr * s) * mask

    chips = fma32(code_phase_steps[:, None], n[None, :],
                  rem_code_phases[:, None])
    idx_f = (chips[:, None, :] + tap_offsets[None, :, None]) * float(table_rate)
    lt = code_tables.shape[-1]
    idx = torch.remainder(torch.floor(idx_f).to(torch.int32), lt)  # [C, K, N]
    codes_kn = torch.gather(code_tables, 1,
                            idx.reshape(idx.shape[0], -1).long()
                            ).reshape(idx.shape)                   # [C, K, N]
    x2 = torch.stack([xr, xi], dim=1)                              # [C, 2, N]
    return _block_sum(codes_kn[:, :, None, :] * x2[:, None])       # [C, K, 2]


def _block_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum the last axis of ``p`` [..., N] in the order the kernels' thread
    block sums it (csrc/epoch_correlate.cuh): each of BLOCK_THREADS threads
    adds the samples t, t + BLOCK_THREADS, ... in order, a warp-shuffle tree
    halves each warp's 32 sums, then the warps' sums are added in order. So
    the plain version and the kernels give the same bits."""
    n = p.shape[-1]
    rows = -(-n // BLOCK_THREADS)
    p = torch.nn.functional.pad(p, (0, rows * BLOCK_THREADS - n))
    p = p.reshape(*p.shape[:-1], rows, BLOCK_THREADS)
    acc = p[..., 0, :]
    for r in range(1, rows):
        acc = acc + p[..., r, :]
    lanes = acc.reshape(*acc.shape[:-1], BLOCK_THREADS // 32, 32)
    for d in (16, 8, 4, 2, 1):
        lanes = lanes[..., :d] + lanes[..., d:2 * d]
    warps = lanes[..., 0]
    out = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        out = out + warps[..., w]
    return out


def _check(chunk, offsets, n_samples, code_tables, params, tap_offsets,
           n_max: int, table_rate: int) -> None:
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
    if code_tables.dtype != torch.float32 or code_tables.ndim != 2:
        raise ValueError(f"code_tables must be float32 [C, Lt], got "
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

    Returns [C, K, 2] float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (and count the launch), or raise.
    """
    if tap_components is not None:
        raise NotImplementedError(
            "tap_components (pilot tracking) is not in the ported kernel's "
            "contract yet")
    chunk = iq.as_iq2(chunk)
    params = dict(rem_code_phases=rem_code_phases,
                  code_phase_steps=code_phase_steps,
                  carr_phase_fracs=carr_phase_fracs,
                  carr_phase_steps=carr_phase_steps)
    _check(chunk, offsets, n_samples, code_tables, params, tap_offsets,
           n_max, table_rate)
    if chunk.device.type == "cpu":
        return epoch_correlate_plain(
            chunk, offsets, n_samples, code_tables, rem_code_phases,
            code_phase_steps, carr_phase_fracs, carr_phase_steps, tap_offsets,
            n_max=n_max, table_rate=table_rate)
    if chunk.device.type != "cuda":
        raise ValueError(f"unsupported device {chunk.device}")
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
