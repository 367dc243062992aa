// One epoch of the multicorrelator, for one channel, on one thread block:
// the body shared by the standalone multicorrelator (correlator.cu, K1) and
// the fused tracking kernel (tracking.cu, K2). It is the CUDA form of the
// Pallas kernel gnss_sdr_tpu/ops/correlator_pallas.py:_kernel.
//
// Over n < ns, for the samples x[n] that lie inside the chunk (n_lo <= n <
// n_hi):
//   x     *= exp(-j 2 pi ((frac + step n) mod 1))                 (carrier wipe)
//   out_k += x * code[floor((rem + cps n + tap_k) tr) mod Lt]     (code gather)
// giving out[2k] (I) and out[2k + 1] (Q) for k < n_taps.
//
// Each thread strides over the window with 2K partial sums in registers,
// adding its samples in order; a warp-shuffle tree then an in-order sum over
// the warps finishes the block, so a result does not change from run to run.
// The window may be passed whole (epoch_correlate_block, K1) or tile by tile
// (epoch_accumulate per tile, then epoch_reduce: K2), with the same bits.
// Each tap reads one component of a [G, Lt] table (pilot tracking: E1-C taps
// and one E1-B data prompt).
//
// Rounding: the body computes the bits of the plain PyTorch version
// (ops/correlator.py:epoch_correlate_plain), op for op, so the kernels can be
// held to it exactly over thousands of dependent tracking steps. Every
// float op is an intrinsic that states its rounding, whatever the including
// file's -fmad setting: the two product-sums (carrier phase and code phase)
// are a float64 product plus a float64 sum rounded once to float32, as the
// plain version's fma32 computes them (the JAX reference's compiler fuses
// them into one FMA, which differs only on a double-rounding tie); the wipe
// is separate products and sums; each code tap's product is rounded before
// it is added; sinf / cosf are the accurate functions PyTorch's torch.sin /
// torch.cos call (never the fast __sinf / __cosf); the block sums in the
// fixed order the plain version's _block_sum repeats.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GNSS_MAX_TAPS 8
// Threads per block of both kernels (one block per channel), and so the
// order in which a block sums a window, which the plain version repeats
// (ops/correlator.py BLOCK_THREADS). 512 was the fastest of 128 / 256 / 512
// / 1024 for the fused tracking kernel on an H100 (PERF.md).
#define GNSS_THREADS 512

// a*b + c as the plain version's fma32: the float64 product is exact, the
// float64 sum is rounded once to float32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return (float)__dadd_rn(__dmul_rn((double)a, (double)b), (double)c);
}

// The block's reduction scratch: one row of 2K partial sums per warp.
struct EpochReduce {
  float part[GNSS_THREADS / 32][2 * GNSS_MAX_TAPS];
};

// One thread's running sums of an epoch: I and Q of each tap.
struct EpochAcc {
  float v[2 * GNSS_MAX_TAPS];
};

__device__ __forceinline__ void epoch_acc_zero(EpochAcc& a) {
#pragma unroll
  for (int k = 0; k < 2 * GNSS_MAX_TAPS; ++k) a.v[k] = 0.f;
}

// Add this thread's samples n of [n_from, n_to) to `a`: n = n_from +
// threadIdx.x, then steps of GNSS_THREADS. x[n - x_base] is sample n of the
// window, so a window can be passed tile by tile (x then points at a tile
// whose first sample is n = x_base); when every tile starts at a multiple of
// GNSS_THREADS, each thread meets its samples in the same order as over the
// whole window and the sums are bit for bit those of one pass. `code` holds
// the channel's tables, component g at code + g * table_len; tap k reads
// component comp[k] (comp null: component 0 for every tap).
__device__ __forceinline__ void epoch_accumulate(
    EpochAcc& a, const float2* __restrict__ x, int x_base, int n_from,
    int n_to, const float* __restrict__ code, int table_len, float rem,
    float cps, float frac, float step, const float* __restrict__ taps,
    const int* __restrict__ comp, int n_taps, int table_rate) {
  const float tr = (float)table_rate;
  const float two_pi = 6.28318548202514648f;      // float32(2 pi)
  float tap[GNSS_MAX_TAPS];
  int base[GNSS_MAX_TAPS];
#pragma unroll
  for (int k = 0; k < GNSS_MAX_TAPS; ++k) {
    tap[k] = k < n_taps ? taps[k] : 0.f;
    base[k] = (k < n_taps && comp != nullptr) ? comp[k] * table_len : 0;
  }
  for (int n = n_from + (int)threadIdx.x; n < n_to; n += GNSS_THREADS) {
    const float2 w = x[n - x_base];
    const float nf = (float)n;
    float ph = fma32(step, nf, frac);
    ph = __fsub_rn(ph, floorf(ph));               // mod 1 (floor semantics)
    const float arg = __fmul_rn(two_pi, ph);
    const float sn = sinf(arg), cs = cosf(arg);
    // (wr + j wi)(c - j s)
    const float xr = __fadd_rn(__fmul_rn(w.x, cs), __fmul_rn(w.y, sn));
    const float xi = __fsub_rn(__fmul_rn(w.y, cs), __fmul_rn(w.x, sn));
    const float chips = fma32(cps, nf, rem);
#pragma unroll
    for (int k = 0; k < GNSS_MAX_TAPS; ++k) {
      if (k < n_taps) {
        int idx = (int)floorf(__fmul_rn(__fadd_rn(chips, tap[k]), tr));
        idx = ((idx % table_len) + table_len) % table_len;   // floor-mod
        const float cv = code[base[k] + idx];
        a.v[2 * k] = __fadd_rn(a.v[2 * k], __fmul_rn(cv, xr));
        a.v[2 * k + 1] = __fadd_rn(a.v[2 * k + 1], __fmul_rn(cv, xi));
      }
    }
  }
}

// Sum the block's threads' `a` in the fixed order (a warp-shuffle tree,
// then the warps in order). Every thread calls it; threads 0 ..
// 2*n_taps-1 write `out` after a block barrier, and the caller synchronises
// before reading it.
__device__ __forceinline__ void epoch_reduce(const EpochAcc& a, int n_taps,
                                             EpochReduce& red,
                                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 2 * GNSS_MAX_TAPS; ++k) {
    float v = a.v[k];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, d));
    if (lane == 0) red.part[warp][k] = v;
  }
  __syncthreads();
  if ((int)threadIdx.x < 2 * n_taps) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < GNSS_THREADS / 32; ++w)
      v = __fadd_rn(v, red.part[w][threadIdx.x]);
    out[threadIdx.x] = v;
  }
}

// Correlate one epoch in one pass. Every thread of the block calls it. `x`
// points at sample `off` of the chunk (global or shared memory); `code` is
// the channel's table (shared memory, one component); `taps` holds n_taps
// tap offsets [chips]. Over n < ns with n_lo <= n < n_hi.
__device__ __forceinline__ void epoch_correlate_block(
    const float2* __restrict__ x, int n_lo, int n_hi, int ns,
    const float* __restrict__ code, int table_len, float rem, float cps,
    float frac, float step, const float* __restrict__ taps, int n_taps,
    int table_rate, EpochReduce& red, float* __restrict__ out) {
  EpochAcc a;
  epoch_acc_zero(a);
  epoch_accumulate(a, x, 0, max(n_lo, 0), min(ns, n_hi), code, table_len,
                   rem, cps, frac, step, taps, nullptr, n_taps, table_rate);
  epoch_reduce(a, n_taps, red, out);
}
