// One epoch of the multicorrelator, for one channel: the body shared by the
// standalone multicorrelator (correlator.cu, K1) and the fused tracking
// kernel (tracking.cu, K2). It is the CUDA form of the Pallas kernel
// gnss_sdr_tpu/ops/correlator_pallas.py:_kernel.
//
// Over n < ns, for the samples x[n] that lie inside the chunk (n_lo <= n <
// n_hi):
//   x     *= exp(-j 2 pi ((frac + step n) mod 1))                 (carrier wipe)
//   out_k += x * code[floor((rem + cps n + tap_k) tr) mod Lt]     (code gather)
// giving out[2k] (I) and out[2k + 1] (Q) for k < n_taps.
//
// The sum's order is fixed by GNSS_THREADS lanes: lane t adds the samples
// t, t + GNSS_THREADS, ... in order, a warp-shuffle tree sums each warp's 32
// lanes, then the warps' sums are added in order. Nothing in that order
// depends on which block runs a lane, so the lanes may be split over the
// blocks of a thread-block cluster (K2) or run by one block (K1) with the
// same bits. A lane's samples may be passed whole or tile by tile. Each tap
// reads one component of a [G, Lt] table (pilot tracking: E1-C taps and one
// E1-B data prompt).
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
// it is added; sincosf is the accurate function, whose two results are
// those of sinf and cosf, which PyTorch's torch.sin / torch.cos call (never
// the fast __sinf / __cosf); the lanes sum in the fixed order the plain
// version's _block_sum repeats.
//
// Cheap paths that keep the bits: the code index's floor-mod by the table
// length is a compare-and-add when every index of the window lies in
// [-Lt, 2 Lt) (epoch_wrap_ok; the integer % otherwise, on a branch every
// thread of the block takes alike); a lane handles its samples two at a
// time, adding them in order; the reduction shuffles 2 n_taps values, not
// 2 GNSS_MAX_TAPS.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GNSS_MAX_TAPS 8
// Lanes of one channel's sum (and threads of a K1 block), and so the order
// in which a window is summed, which the plain version repeats
// (ops/correlator.py BLOCK_THREADS). 512 was the fastest of 128 / 256 / 512
// / 1024 for the fused tracking kernel on an H100 (PERF.md).
#define GNSS_THREADS 512
#define GNSS_WARPS (GNSS_THREADS / 32)

// a*b + c as the plain version's fma32: the float64 product is exact, the
// float64 sum is rounded once to float32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return (float)__dadd_rn(__dmul_rn((double)a, (double)b), (double)c);
}

// The block's reduction scratch (K1): one row of 2K partial sums per warp.
struct EpochReduce {
  float part[GNSS_WARPS][2 * GNSS_MAX_TAPS];
};

// One lane's running sums of an epoch: I and Q of each tap.
struct EpochAcc {
  float v[2 * GNSS_MAX_TAPS];
};

// The NCO of one epoch window, the same for every lane: code phase [chips]
// at n = 0, chips per sample, carrier phase [cycles] at n = 0, cycles per
// sample.
struct EpochNco {
  float rem, cps, frac, step;
};

__device__ __forceinline__ void epoch_acc_zero(EpochAcc& a) {
#pragma unroll
  for (int k = 0; k < 2 * GNSS_MAX_TAPS; ++k) a.v[k] = 0.f;
}

// The code-table index of sample n's tap before the floor-mod.
__device__ __forceinline__ float code_index_f(const EpochNco& e, float nf,
                                              float tap, float tr) {
  return floorf(__fmul_rn(__fadd_rn(fma32(e.cps, nf, e.rem), tap), tr));
}

// Whether every code index of the samples n0 <= n < n1 lies in [-Lt, 2 Lt),
// where the floor-mod is one compare-and-add. The index is a floor of
// rounded sums and products, each monotone in n and in the tap, so its
// extremes are at the window's ends and the outer taps. On a tracking
// window rem lies in [0, code_len) and cps n < code_len + cps, so with |tap|
// < 1 chip the index lies in [-tr, 2 code_len tr) and the test holds; a
// carry outside that (an idle channel's, or a NaN) takes the % path.
__device__ __forceinline__ bool epoch_wrap_ok(const EpochNco& e, int n0,
                                              int n1, const float* taps,
                                              int n_taps, int table_len,
                                              int table_rate) {
  if (n1 <= n0) return true;
  float tmin = taps[0], tmax = taps[0];
  for (int k = 1; k < n_taps; ++k) {
    tmin = fminf(tmin, taps[k]);
    tmax = fmaxf(tmax, taps[k]);
  }
  const float tr = (float)table_rate;
  const float a = (float)n0, b = (float)(n1 - 1);
  const float lo = fminf(code_index_f(e, a, tmin, tr),
                         code_index_f(e, b, tmin, tr));
  const float hi = fmaxf(code_index_f(e, a, tmax, tr),
                         code_index_f(e, b, tmax, tr));
  const float lt = (float)table_len;
  return lo >= -lt && hi < 2.f * lt;       // false for a NaN
}

// Sample n's 2K tap products: the carrier wipe of w, then each tap's code
// entry times it. kTaps: the tap count, or 0 for n_taps at run time;
// kRouted: tap k reads component base[k] / table_len of the tables; kWrap:
// the index lies in [-Lt, 2 Lt) (epoch_wrap_ok).
template <int kTaps, bool kRouted, bool kWrap>
__device__ __forceinline__ void epoch_sample(
    float* __restrict__ prod, float2 w, int n, const EpochNco& e,
    const float* tap, const int* base, const float* __restrict__ code,
    int table_len, int n_taps, float tr) {
  constexpr int NT = kTaps ? kTaps : GNSS_MAX_TAPS;
  const float two_pi = 6.28318548202514648f;      // float32(2 pi)
  const float nf = (float)n;
  float ph = fma32(e.step, nf, e.frac);
  ph = __fsub_rn(ph, floorf(ph));               // mod 1 (floor semantics)
  float sn, cs;
  sincosf(__fmul_rn(two_pi, ph), &sn, &cs);
  // (wr + j wi)(c - j s)
  const float xr = __fadd_rn(__fmul_rn(w.x, cs), __fmul_rn(w.y, sn));
  const float xi = __fsub_rn(__fmul_rn(w.y, cs), __fmul_rn(w.x, sn));
  const float chips = fma32(e.cps, nf, e.rem);
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (kTaps || k < n_taps) {
      int idx = (int)floorf(__fmul_rn(__fadd_rn(chips, tap[k]), tr));
      if (kWrap) {
        idx += idx < 0 ? table_len : 0;
        idx -= idx >= table_len ? table_len : 0;
      } else {
        idx = ((idx % table_len) + table_len) % table_len;   // floor-mod
      }
      const float cv = code[(kRouted ? base[k] : 0) + idx];
      prod[2 * k] = __fmul_rn(cv, xr);
      prod[2 * k + 1] = __fmul_rn(cv, xi);
    }
  }
}

// Add one lane's samples n, n + GNSS_THREADS, ... (< n_end) to `a`, in
// order. xs points at the lane's sample n; its later samples follow at a
// stride of rs float2 (the chunk itself: GNSS_THREADS; a tile ring holding
// only some lanes' samples: that many lanes). `code` holds the channel's
// tables, component g at code + g * table_len; tap k reads component
// comp[k] when kRouted. Two samples per iteration, added in order.
template <int kTaps, bool kRouted, bool kWrap>
__device__ __forceinline__ void epoch_accumulate(
    EpochAcc& a, const float2* __restrict__ xs, int rs, int n, int n_end,
    const float* __restrict__ code, int table_len, const EpochNco& e,
    const float* __restrict__ taps, const int* __restrict__ comp,
    int n_taps, int table_rate) {
  constexpr int NT = kTaps ? kTaps : GNSS_MAX_TAPS;
  const float tr = (float)table_rate;
  float tap[NT];
  int base[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const bool on = kTaps || k < n_taps;
    tap[k] = on ? taps[k] : 0.f;
    base[k] = (on && kRouted) ? comp[k] * table_len : 0;
  }
  float p0[2 * NT], p1[2 * NT];
  for (; n + GNSS_THREADS < n_end; n += 2 * GNSS_THREADS, xs += 2 * rs) {
    const float2 w0 = xs[0], w1 = xs[rs];
    epoch_sample<kTaps, kRouted, kWrap>(p0, w0, n, e, tap, base, code,
                                        table_len, n_taps, tr);
    epoch_sample<kTaps, kRouted, kWrap>(p1, w1, n + GNSS_THREADS, e, tap,
                                        base, code, table_len, n_taps, tr);
#pragma unroll
    for (int k = 0; k < 2 * NT; ++k) {
      if (kTaps || k < 2 * n_taps) {
        a.v[k] = __fadd_rn(a.v[k], p0[k]);
        a.v[k] = __fadd_rn(a.v[k], p1[k]);
      }
    }
  }
  if (n < n_end) {
    epoch_sample<kTaps, kRouted, kWrap>(p0, xs[0], n, e, tap, base, code,
                                        table_len, n_taps, tr);
#pragma unroll
    for (int k = 0; k < 2 * NT; ++k)
      if (kTaps || k < 2 * n_taps) a.v[k] = __fadd_rn(a.v[k], p0[k]);
  }
}

// epoch_accumulate with the floor-mod path chosen once for the window
// (every caller's thread of the block passes the same `wrap`).
template <int kTaps, bool kRouted>
__device__ __forceinline__ void epoch_accumulate_any(
    bool wrap, EpochAcc& a, const float2* __restrict__ xs, int rs, int n,
    int n_end, const float* __restrict__ code, int table_len,
    const EpochNco& e, const float* __restrict__ taps,
    const int* __restrict__ comp, int n_taps, int table_rate) {
  if (wrap)
    epoch_accumulate<kTaps, kRouted, true>(a, xs, rs, n, n_end, code,
                                           table_len, e, taps, comp, n_taps,
                                           table_rate);
  else
    epoch_accumulate<kTaps, kRouted, false>(a, xs, rs, n, n_end, code,
                                            table_len, e, taps, comp, n_taps,
                                            table_rate);
}

// The warp-shuffle tree over a warp's 32 lanes, for the 2 n_taps sums in
// use: lane 0 ends with each warp sum. Every lane of the warp calls it.
template <int kTaps>
__device__ __forceinline__ void epoch_warp_reduce(EpochAcc& a, int n_taps) {
  constexpr int NT = kTaps ? kTaps : GNSS_MAX_TAPS;
#pragma unroll
  for (int k = 0; k < 2 * NT; ++k) {
    if (kTaps || k < 2 * n_taps) {
      float v = a.v[k];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, d));
      a.v[k] = v;
    }
  }
}

// Sum one block of GNSS_THREADS lanes' `a` in the fixed order (K1). Every
// thread calls it; threads 0 .. 2*n_taps-1 write `out` after a block
// barrier, and the caller synchronises before reading it.
__device__ __forceinline__ void epoch_reduce(EpochAcc& a, int n_taps,
                                             EpochReduce& red,
                                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  epoch_warp_reduce<0>(a, n_taps);
  if (lane == 0)
    for (int k = 0; k < 2 * n_taps; ++k) red.part[warp][k] = a.v[k];
  __syncthreads();
  if ((int)threadIdx.x < 2 * n_taps) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < GNSS_WARPS; ++w)
      v = __fadd_rn(v, red.part[w][threadIdx.x]);
    out[threadIdx.x] = v;
  }
}

// Correlate one epoch in one pass on one block of GNSS_THREADS threads (K1).
// `x` points at sample `off` of the chunk (global memory); `code` is the
// channel's table (shared memory, one component); `taps` holds n_taps tap
// offsets [chips]. Over n < ns with n_lo <= n < n_hi.
__device__ __forceinline__ void epoch_correlate_block(
    const float2* __restrict__ x, int n_lo, int n_hi, int ns,
    const float* __restrict__ code, int table_len, float rem, float cps,
    float frac, float step, const float* __restrict__ taps, int n_taps,
    int table_rate, EpochReduce& red, float* __restrict__ out) {
  const EpochNco e{rem, cps, frac, step};
  const int n0 = max(n_lo, 0), n1 = min(ns, n_hi);
  const bool wrap =
      epoch_wrap_ok(e, n0, n1, taps, n_taps, table_len, table_rate);
  const int n = n0 + (int)threadIdx.x;
  EpochAcc a;
  epoch_acc_zero(a);
  epoch_accumulate_any<0, false>(wrap, a, x + n, GNSS_THREADS, n, n1, code,
                                 table_len, e, taps, nullptr, n_taps,
                                 table_rate);
  epoch_reduce(a, n_taps, red, out);
}
