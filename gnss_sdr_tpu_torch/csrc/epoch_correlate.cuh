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

// Correlate one epoch. Every thread of the block calls it. `x` points at
// sample `off` of the chunk (global or shared memory); `code` is
// the channel's table (shared memory); `taps` holds n_taps tap offsets
// [chips]. Threads 0 .. 2*n_taps-1 write `out` after a block barrier; the
// caller synchronises before reading it.
__device__ __forceinline__ void epoch_correlate_block(
    const float2* __restrict__ x, int n_lo, int n_hi, int ns,
    const float* __restrict__ code, int table_len, float rem, float cps,
    float frac, float step, const float* __restrict__ taps, int n_taps,
    int table_rate, EpochReduce& red, float* __restrict__ out) {
  const float tr = (float)table_rate;
  const float two_pi = 6.28318548202514648f;      // float32(2 pi)
  float tap[GNSS_MAX_TAPS];
#pragma unroll
  for (int k = 0; k < GNSS_MAX_TAPS; ++k) tap[k] = k < n_taps ? taps[k] : 0.f;

  float acc[2 * GNSS_MAX_TAPS];
#pragma unroll
  for (int k = 0; k < 2 * GNSS_MAX_TAPS; ++k) acc[k] = 0.f;

  const int lo = max(n_lo, 0);
  const int hi = min(ns, n_hi);
  for (int n = lo + (int)threadIdx.x; n < hi; n += GNSS_THREADS) {
    const float2 w = x[n];
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
        const float cv = code[idx];
        acc[2 * k] = __fadd_rn(acc[2 * k], __fmul_rn(cv, xr));
        acc[2 * k + 1] = __fadd_rn(acc[2 * k + 1], __fmul_rn(cv, xi));
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 2 * GNSS_MAX_TAPS; ++k) {
    float v = acc[k];
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
