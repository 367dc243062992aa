// Fused tracking kernel for Hopper (sm_90a), K2: the whole tracking loop of
// one dispatch in one launch. It replaces the JAX package's device program
// for a chunk, the lax.scan of `step` in gnss_sdr_tpu/receiver/tracking.py:
// 432-632, with the Pallas multicorrelator correlator_pallas.py:70 inlined
// (epoch_correlate.cuh, the body K1 runs too). Its plain version is the
// eager loop of gnss_sdr_tpu_torch/receiver/tracking.py:track_chunk.
//
// Design: each channel runs on a thread-block cluster of m blocks (m in 1,
// 2, 4, 8; TrackParams.cluster), looping over the dispatch's n_steps code
// epochs. The channel's sums are those of GNSS_THREADS lanes
// (epoch_correlate.cuh); block r of the cluster runs lanes [r L, (r+1) L),
// L = GNSS_THREADS / m, whole warps. Per step:
//   1. every thread correlates its lane's samples of the epoch window
//      against K code taps, streaming them through a ring of two tiles in
//      its block's shared memory: each thread fetches with cp.async exactly
//      the samples it adds (one tile ahead: the next tile of this epoch, or
//      after the last one the first tile of the next epoch, whose offset is
//      known before this epoch's correlation starts), so the ring needs no
//      block barrier; the lane keeps its 2K partial sums in registers from
//      tile to tile;
//   2. each warp's shuffle tree sums its lanes; lane 0 writes the warp's
//      row into its block's shared memory, double-buffered by step parity;
//      one cluster barrier;
//   3. warp 0 of every block reads the 16 warp rows through distributed
//      shared memory, in warp order, so every block holds the same
//      correlation, and runs the scalar loop update on it and on its own
//      copy of the carry: secondary-code wipe and coherent accumulation,
//      EMLP / Costas / FLL discriminators, DLL2 / PLL3 loop filters with the
//      FLL in pull-in, C/N0 and the lock metric, the lock-fail counter and
//      loss latch, the PULL_IN -> WIDE -> NARROW state machine and the NCO
//      advance; in the KF variants (kKf) also, after the C/N0 estimate, the
//      Kalman carrier filter's predict and update (kf_step) for channels
//      past pull-in, whose frequency and phase jump drive the NCO. The
//      update is deterministic, so the blocks need no broadcast; block 0
//      alone writes the step's row of the packed [S, C, 13] host outputs
//      (pack_host_outputs' layout). The warp's lanes each
//      run one of the update's independent library calls (the three
//      magnitudes, the two arctangents) and shuffle the results to the
//      others. One block barrier publishes the next epoch's NCO state.
// At the end (one more cluster barrier, so no block leaves while another
// reads its rows) block 0 rebases sample_offset by -chunk_len for active
// channels, writes the loss flag into column 12 of every row and stores
// the carry.
//
// What bounds it on an H100: not bytes and not FLOPs. A 100 ms GPS L1 chunk
// is 1.6 MB of samples read through the 50 MB L2 and ~0.2 MFLOP per channel
// per step; the time is the chain of n_steps dependent steps, each a window
// pass of ~2000 (GPS L1, 2 MSps) to ~12,000 (Galileo E5a, 12 MSps) samples
// over the channel's 512 lanes, a reduction, a scalar update of ~150
// dependent float ops and a few barriers. With one block per channel (the
// kernel's first design) the 4-8 channels of a receiver kept 4-8 of the 132
// SMs busy and the time per chunk was the same at C=4 and C=128. Timed by parts (the
// K2_PARTS builds, chip_smoke.py), a step now takes ~4 us for GPS L1 (m=1:
// ring fill and barriers ~0.6, accumulate ~1.3, reduction ~0.6, update
// ~1.5) and ~8-9 us for L5 / E5a at C=4 (m=8: ~1.5, ~3.6-4.2, ~1.4,
// ~1.7-2.1): the per-step fixed costs are now half of it.
// What the design does about it:
//   - one launch per dispatch instead of ~231 eager operations per step;
//   - the cluster spreads one channel's per-sample work over m SMs, and the
//     sums keep their bits, since a lane's samples and the order of the
//     warps do not depend on the block that runs them; the wrapper picks m
//     from C, n_max and the card's room for clusters
//     (ops/tracking_kernel.py:pick_cluster): m = 1 for short windows
//     (GPS L1), where the cluster's barrier costs more than it spreads, and
//     where C fills the card;
//   - the code tables (both components of a [2, Lt] table under pilot
//     tracking) are staged in each block's shared memory once per
//     dispatch; the ring takes 2 x tile / m samples, tile = n_max rounded
//     up to a multiple of GNSS_THREADS, at most K2_TILE_MAX = 4096;
//   - per sample no integer division where the window's code indices are
//     known to lie in [-Lt, 2 Lt), sincosf in place of sinf + cosf, two
//     samples per iteration; the shuffle tree over 2 n_taps sums only; the
//     tap count and the routing compiled in for the receivers' tap sets;
//   - the update's library calls spread over warp 0's lanes.
// Tensor cores do not apply: the product is [K <= 8, N] x [N, 2].
//
// Rounding. The kernel follows its plain version on the card op for op, and
// on an H100 gives its bits over 1602 steps: the eager loop's integer
// fields are floors and ceils of float sums, and its PLL / DLL loops turn a
// last-bit difference per step into more than 1e-4 within ~1600 steps. So:
//   - the correlation is epoch_correlate.cuh, whose bits the plain
//     correlator repeats (ops/correlator.py:_block_sum);
//   - every float op of the update is an intrinsic that states its rounding
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), as each of PyTorch's
//     separate elementwise kernels rounds, so nvcc contracts nothing; the
//     library functions (hypotf, log10f, sincosf) are built with nvcc's
//     default flags, as PyTorch's own kernels are (never --use_fast_math,
//     never -fmad=false, which would change them);
//   - the arctangent is atan32, the C library's atanf that the JAX
//     reference's CPU backend calls, written out op for op as the eager
//     loop's ops/discriminators.py:atan32;
//   - the fused sums of the eager step (fma32: fll_freq, new_code_freq,
//     tot, new_rem and the C/N0 moments) are a float64 product plus a
//     float64 sum rounded once to float32, as fma32 computes them;
//   - IEEE division: n_samp = ceil((code_len - rem) / safe_cps);
//   - a tensor divided by a Python scalar is, in PyTorch's CUDA division, a
//     multiply by the scalar's reciprocal taken in float64 and rounded to
//     float32 (the wrapper passes those reciprocals: 1/0.7845, 1/0.53,
//     1/(2 pi)); a tensor times a Python scalar is a float32 product with
//     the scalar rounded to float32;
//   - x ** 2 and x ** 3 are PyTorch's CUDA pow specialisations x*x and
//     (x*x)*x; mixed products keep Python's left-to-right order
//     (a3 * w0p ** 2 * phase_err = ((w0p*w0p) * a3) * phase_err);
//   - |z| of a complex is hypotf; the FLL's complex product rounds as
//     c10::complex's operator* compiles;
//   - torch.remainder of int32 is a floor-mod (C's % truncates).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "epoch_correlate.cuh"

namespace cg = cooperative_groups;

// Layout of one channel's packed carry row (int32 words; floats bitcast,
// bools as 0/1). gnss_sdr_tpu_torch/ops/tracking_kernel.py:CARRY_FIELDS
// lists the same fields in the same order ("cn0.ema_p2" is W_CN0_EMA_P2).
enum CarryWord {
  W_ACTIVE, W_STATE, W_SAMPLE_OFFSET, W_REM_CODE_PHASE, W_CODE_FREQ,
  W_CARRIER_FREQ, W_CARR_PHASE_FRAC, W_CARR_PHASE_CYCLES, W_DLL_ACC1,
  W_PLL_ACC1, W_PLL_ACC2, W_PREV_PROMPT_0, W_PREV_PROMPT_1, W_CN0_EMA_ABS_I,
  W_CN0_EMA_P2, W_CN0_EMA_I2_MINUS_Q2, W_CN0_EMA_I2_PLUS_Q2, W_EPOCHS_IN_STATE,
  W_EPOCH_COUNT, W_LOCK_FAIL, W_LOSS_OF_LOCK, W_EXT_N, W_EXT_ANCHOR,
  W_SEC_LEN, W_SEC_ANCHOR, W_ACC_DT, W_ACC_CNT, W_KF_ACC, W_IF_FREQ,
  W_ACC_CORR  // then 2K words of acc_corr, then 9 of kf_p (row-major)
};

#define PACKED_COLS 13
#define PULL_IN 1
#define WIDE_TRACK 2
#define NARROW_TRACK 3
#define MAX_DYN_SMEM (227 * 1024 - 4096)
// the window ring's tile length bound [samples] (ops/tracking_kernel.py
// TILE_MAX): two tiles of float2 take at most 64 KB
#define K2_TILE_MAX 4096
// the largest cluster (blocks per channel) the kernel takes
#define K2_CLUSTER_MAX 8
// The parts of a step the kernel runs: all of them, unless a timing build
// leaves some out (ops/tracking_kernel.py PART_BUILDS) to time the rest.
#define K2_FILL 1
#define K2_ACCUMULATE 2
#define K2_REDUCE 4
#define K2_UPDATE 8
#ifndef K2_PARTS
#define K2_PARTS (K2_FILL | K2_ACCUMULATE | K2_REDUCE | K2_UPDATE)
#endif

// Static configuration of one dispatch (tracking_kernel.py:_Params mirrors
// it field for field: 4-byte ints, then 4-byte floats, the taps' offsets
// and the taps' table components). n_taps counts every tap, the data prompt
// of pilot tracking included; table_len is one component's length and
// n_comp the components (1, or 2 under pilot tracking: pilot, data);
// cluster is m, the blocks per channel. The Kalman carrier loop's fields
// come last: on or off (TrackingConfig.carrier_kf, which picks the kKf
// variants), its process noise densities and log2(10) as the C library's
// powf takes it (ops/kalman.py powf_log2).
struct TrackParams {
  int n_ch, n_steps, n_max, chunk_len, length, table_len, table_rate, n_taps;
  int prompt_index, data_prompt_index, sec_stride, pull_in_epochs;
  int wide_epochs, max_lock_fail, carry_width, n_comp, tile, cluster;
  float inv_fs, code_len, min_cps, emlp_scale, inv_two_pi, two_pi, fll_gain;
  float code_to_carrier, code_rate, pll_bw, pll_bw_narrow, dll_bw;
  float dll_bw_narrow, inv_pll_w0, inv_dll_w0, a3, b3, a2, cn0_alpha;
  float cn0_min, lock_min, eps20, eps12;
  float taps[GNSS_MAX_TAPS];
  int tap_comp[GNSS_MAX_TAPS];
  int carrier_kf;
  float kf_q_phase, kf_q_freq, kf_q_rate;
  double kf_log2_10;
};

struct Carry {
  int active, state, off, cycles, eis, ecount, lock_fail, loss;
  int ext_n, ext_anchor, sec_len, sec_anchor, acc_cnt;
  float rem, code_freq, carrier_freq, frac, dll1, pll1, pll2;
  float prev_i, prev_q, e_abs_i, e_p2, e_mq, e_pq, acc_dt, if_freq;
  float acc[2 * GNSS_MAX_TAPS];
};

// A channel's carry in a kernel variant: the Kalman carrier loop's words
// (kf_acc, the covariance kf_p) only where the variant runs the KF update.
template <bool kKf> struct ChannelCarry : Carry {};
template <> struct ChannelCarry<true> : Carry {
  float kf_acc, kf_p[9];
};

// The NCO state of the next epoch, published to the block. wrap: every
// code index of the window lies in [-Lt, 2 Lt) (epoch_wrap_ok).
struct EpochPlan {
  int n_samp, valid, off, ns, cnt, next_off, wrap;
  float cps, frac, step, rem;
};

__device__ __forceinline__ float f_of(int w) { return __int_as_float(w); }
__device__ __forceinline__ int w_of(float f) { return __float_as_int(f); }

// PyTorch's clamp_min of a float: NaN propagates
__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.remainder of int32 (b >= 1 here): a floor-mod
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// The C library's float32 atanf (fdlibm's __atanf) that XLA's CPU backend
// calls for jnp.arctan, each op rounded once in its order; the eager loop's
// ops/discriminators.py:atan32 computes the same ops.
__device__ __forceinline__ float atan32(float x) {
  const float ax = fabsf(x);
  const int ix = __float_as_int(ax);
  const int k = (ix >= 0x3ee00000) + (ix >= 0x3f300000) +
                (ix >= 0x3f980000) + (ix >= 0x401c0000);
  // the reduced argument (p |x| - q) / (r + s |x|) and atan's hi + lo at
  // the interval's centre, by interval (|x| < 7/16, < 11/16, < 19/16,
  // < 39/16, beyond)
  const float P[5] = {1.f, 2.f, 1.f, 1.f, 0.f};
  const float Q[5] = {0.f, 1.f, 1.f, 1.5f, 1.f};
  const float R[5] = {1.f, 2.f, 1.f, 1.f, 0.f};
  const float S[5] = {0.f, 1.f, 1.f, 1.5f, 1.f};
  const float HI[5] = {0.f, __int_as_float(0x3eed6338),
                       __int_as_float(0x3f490fda), __int_as_float(0x3f7b985e),
                       __int_as_float(0x3fc90fda)};
  const float LO[5] = {0.f, __int_as_float(0x31ac3769),
                       __int_as_float(0x33222168), __int_as_float(0x33140fb4),
                       __int_as_float(0x33a22168)};
  const float t = __fdiv_rn(__fsub_rn(__fmul_rn(P[k], ax), Q[k]),
                            __fadd_rn(R[k], __fmul_rn(S[k], ax)));
  const float z = __fmul_rn(t, t);
  const float w = __fmul_rn(z, z);
#define AT(i, h) __int_as_float(h)
  float s1 = __fadd_rn(AT(8, 0x3d4bda59), __fmul_rn(w, AT(10, 0x3c8569d7)));
  s1 = __fadd_rn(AT(6, 0x3d886b35), __fmul_rn(w, s1));
  s1 = __fadd_rn(AT(4, 0x3dba2e6e), __fmul_rn(w, s1));
  s1 = __fadd_rn(AT(2, 0x3e124925), __fmul_rn(w, s1));
  s1 = __fmul_rn(z, __fadd_rn(AT(0, 0x3eaaaaab), __fmul_rn(w, s1)));
  float s2 = __fadd_rn(AT(7, 0xbd6ef16b), __fmul_rn(w, AT(9, 0xbd15a221)));
  s2 = __fadd_rn(AT(5, 0xbd9d8795), __fmul_rn(w, s2));
  s2 = __fadd_rn(AT(3, 0xbde38e38), __fmul_rn(w, s2));
  s2 = __fmul_rn(w, __fadd_rn(AT(1, 0xbe4ccccd), __fmul_rn(w, s2)));
#undef AT
  float y = __fsub_rn(HI[k], __fsub_rn(__fsub_rn(__fmul_rn(t, __fadd_rn(s1, s2)),
                                                 LO[k]), t));
  if (ax >= 33554432.f) y = __int_as_float(0x3fc90fdb);   // 2^25: pi / 2
  return copysignf(y, x);
}

// glibc's powf(x, y) for y log2(x) = ylogx in float64 (ops/kalman.py
// pow32): 2^(k/32) from the table times a cubic in the remainder, every
// float64 operation rounded as the plain version's separate ones.
__constant__ unsigned long long kExp2Tab[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};

__device__ __forceinline__ float pow32(double logx, float y) {
  const double shift = 0x1.8p+47;
  const double ylogx = __dmul_rn((double)y, logx);
  const double kd = __dsub_rn(__dadd_rn(ylogx, shift), shift);
  const double r = __dsub_rn(ylogx, kd);
  const long long k = (long long)__dmul_rn(kd, 32.0);
  const double s = __longlong_as_double(
      (long long)(kExp2Tab[k & 31] + ((unsigned long long)k << 47)));
  const double z = __dadd_rn(__dmul_rn(0x1.c6af84b912394p-5, r),
                             0x1.ebfce50fac4f3p-3);
  const double r2 = __dmul_rn(r, r);
  const double q = __dadd_rn(__dmul_rn(0x1.62e42ff0c52d6p-1, r), 1.0);
  return (float)__dmul_rn(__dadd_rn(__dmul_rn(z, r2), q), s);
}

// [3][3] a @ b as ops/kalman.py _mm3: each entry's products in index order,
// the second and third fused
__device__ __forceinline__ void mm3(const float a[3][3], const float b[3][3],
                                    float out[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float m = __fmul_rn(a[i][0], b[0][k]);
      m = fma32(a[i][1], b[1][k], m);
      out[i][k] = fma32(a[i][2], b[2][k], m);
    }
}

// One predict + update of the carrier KF (ops/kalman.py
// phase_meas_var_cyc2 and kf_update, op for op) on the channel's
// covariance `p` [9] and rate `accel`, at NCO frequency `freq`, Costas
// error `pe` [cycles], interval `dt` and C/N0 estimate `cn0_est`: the new
// covariance into `p_new`, the frequency, rate and phase-jump estimates.
__device__ void kf_step(const TrackParams& prm, const float* p, float accel,
                        float freq, float pe, float dt, float cn0_est,
                        float* p_new, float& f_hat, float& a_hat,
                        float& phi_hat) {
  // measurement variance [cycles^2] at this C/N0 and max(dt, 1e-4)
  const float coh = clamp_min_f(dt, 1e-4f);
  const float cl =
      isnan(cn0_est) ? cn0_est : fminf(fmaxf(cn0_est, 10.0f), 60.0f);
  const float cn0 = pow32(prm.kf_log2_10, __fmul_rn(cl, 0.1f));
  const float two_snr = __fmul_rn(__fmul_rn(cn0, coh), 2.0f);
  const float var = __fdiv_rn(__fadd_rn(__fdiv_rn(1.0f, two_snr), 1.0f),
                              two_snr);
  // 1 / (4 pi^2) as the float32 reciprocal of float32(4 pi^2)
  const float r = __fmul_rn(var, 0.025330296f);

  const float h = __fmul_rn(__fmul_rn(dt, 0.5f), dt);
  const float f[3][3] = {{1.0f, dt, h}, {0.0f, 1.0f, dt}, {0.0f, 0.0f, 1.0f}};
  const float ft[3][3] = {{1.0f, 0.0f, 0.0f}, {dt, 1.0f, 0.0f}, {h, dt, 1.0f}};
  float pm[3][3], fp[3][3], pp[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) pm[i / 3][i % 3] = p[i];
  mm3(f, pm, fp);
  mm3(fp, ft, pp);
  pp[0][0] = fma32(dt, prm.kf_q_phase, pp[0][0]);
  pp[1][1] = __fadd_rn(pp[1][1], __fmul_rn(dt, prm.kf_q_freq));
  pp[2][2] = fma32(dt, prm.kf_q_rate, pp[2][2]);

  const float a_half_dt = __fmul_rn(__fmul_rn(accel, 0.5f), dt);
  const float phi_pred = __fmul_rn(a_half_dt, dt);
  const float f_pred = fma32(accel, dt, freq);
  const float s = __fadd_rn(pp[0][0], r);
  const float k0 = __fdiv_rn(pp[0][0], s), k1 = __fdiv_rn(pp[1][0], s),
              k2 = __fdiv_rn(pp[2][0], s);
  const float y = __fsub_rn(pe, phi_pred);
  const float y_fused = fma32(-a_half_dt, dt, pe);
  phi_hat = fma32(k0, y, phi_pred);
  f_hat = fma32(k1, y_fused, f_pred);
  a_hat = fma32(k2, y_fused, accel);

  const float ikh[3][3] = {{__fsub_rn(1.0f, k0), 0.0f, 0.0f},
                           {__fsub_rn(0.0f, k1), 1.0f, 0.0f},
                           {__fsub_rn(0.0f, k2), 0.0f, 1.0f}};
  float pn[3][3];
  mm3(ikh, pp, pn);
#pragma unroll
  for (int i = 0; i < 9; ++i)
    p_new[i] = __fmul_rn(__fadd_rn(pn[i / 3][i % 3], pn[i % 3][i / 3]), 0.5f);
}

// The start of an epoch: sample count, validity and NCO steps (tracking.py
// track_chunk, the first lines of each step), and whether the window's code
// indices allow the compare-and-add floor-mod.
__device__ void plan_epoch(const Carry& c, const TrackParams& p,
                           EpochPlan& e) {
  const float cps = __fmul_rn(c.code_freq, p.inv_fs);
  const float safe_cps = clamp_min_f(cps, p.min_cps);
  int n = (int)ceilf(__fdiv_rn(__fsub_rn(p.code_len, c.rem), safe_cps));
  n = min(max(n, 1), p.n_max);
  const bool tracking = c.active && c.state > 0;
  const bool valid = tracking && c.off >= 0 && c.off < p.chunk_len;
  e.n_samp = n;
  e.valid = valid;
  e.off = min(max(c.off, 0), p.chunk_len);
  e.ns = valid ? n : 0;
  e.cnt = min(p.n_max, p.length - e.off);
  e.next_off = min(max(valid ? c.off + n : c.off, 0), p.chunk_len);
  e.cps = cps;
  e.frac = c.frac;
  e.step = __fmul_rn(c.carrier_freq, p.inv_fs);
  e.rem = c.rem;
  const EpochNco nco{e.rem, e.cps, e.frac, e.step};
  e.wrap = epoch_wrap_ok(nco, 0, min(e.ns, e.cnt), p.taps, p.n_taps,
                         p.table_len, p.table_rate);
}

// The loop update of one epoch on the correlation `corr` [K][2]: writes the
// step's packed output row (when `row` is not null) and advances the carry
// `c` (shared memory). Every lane of one warp calls it on the same values:
// lane l evaluates the l-th of each set of independent library calls, and
// the results are shuffled to every lane; lane 0 writes the new carry once
// every lane has read the old one. kTaps / kPilot: the tap set, which fixes
// the prompt's index (0: p.n_taps and p.prompt_index at run time).
template <int kTaps, bool kPilot, bool kKf>
__device__ __forceinline__ void update_epoch(ChannelCarry<kKf>& c,
                                             const TrackParams& p,
                                             const EpochPlan& e,
                                             const float* corr,
                                             const float* sec_row, float* row,
                                             int lane) {
  constexpr int NT = kTaps ? kTaps : GNSS_MAX_TAPS;
  const bool valid = e.valid;
  const int K = kTaps ? kTaps : p.n_taps;
  const float n_samp_f = (float)e.n_samp;
  const float dt = __fmul_rn(n_samp_f, p.inv_fs);
  const int eidx = c.ecount;

  // ---- secondary-code wipe + coherent accumulation ----
  float chip = 1.0f;
  if (sec_row != nullptr && c.sec_len > 0) {
    int sidx = floor_mod(eidx - c.sec_anchor, max(c.sec_len, 1));
    chip = sec_row[min(sidx, p.sec_stride - 1)];
  }
  const float vsel = valid ? 1.0f : 0.0f;
  float acc[2 * NT];
#pragma unroll
  for (int k = 0; k < 2 * NT; ++k) {
    if (kTaps || k < 2 * K) {
      const float w = sec_row != nullptr ? __fmul_rn(corr[k], chip) : corr[k];
      acc[k] = __fadd_rn(c.acc[k], __fmul_rn(w, vsel));
    }
  }
  const float acc_dt = __fadd_rn(c.acc_dt, valid ? dt : 0.0f);
  const int acc_cnt = c.acc_cnt + (valid ? 1 : 0);
  // x mod 1 is 0: the % only for extended integration
  const int rel = c.ext_n == 1 ? 0 : floor_mod(eidx - c.ext_anchor,
                                               max(c.ext_n, 1));
  const bool boundary = valid && rel == c.ext_n - 1;
  const float dt_eff = acc_dt;

  const int pi = kTaps ? (kPilot ? (kTaps - 1) / 2 : kTaps / 2)
                       : p.prompt_index;
  const float pr = acc[2 * pi], pq = acc[2 * pi + 1];

  // ---- discriminators ----
  // |E|, |L| and |prev| on lanes 0, 1 and 2
  const float h = hypotf(
      lane == 0 ? acc[2 * (pi - 1)] : (lane == 1 ? acc[2 * (pi + 1)]
                                                 : c.prev_i),
      lane == 0 ? acc[2 * (pi - 1) + 1] : (lane == 1 ? acc[2 * (pi + 1) + 1]
                                                     : c.prev_q));
  const float ea = __shfl_sync(0xffffffffu, h, 0);
  const float la = __shfl_sync(0xffffffffu, h, 1);
  const float prev_abs = __shfl_sync(0xffffffffu, h, 2);
  const float code_err = __fmul_rn(
      __fdiv_rn(__fsub_rn(ea, la), clamp_min_f(__fadd_rn(ea, la), p.eps20)),
      p.emlp_scale);
  const float safe_i = fabsf(pr) < p.eps20 ? p.eps20 : pr;
  // z = prompt * conj(prev_prompt), as c10::complex's a*c - b*d, a*d + b*c
  // compile (the first product of each pair fused)
  const float zr = __fmaf_rn(pr, c.prev_i, -__fmul_rn(pq, -c.prev_q));
  const float zi = __fmaf_rn(pr, -c.prev_q, __fmul_rn(pq, c.prev_i));
  const float safe_dot = fabsf(zr) < p.eps20 ? p.eps20 : zr;
  // the Costas and FLL arctangents on lanes 0 and 1
  const float at = atan32(lane == 0 ? __fdiv_rn(pq, safe_i)
                                    : __fdiv_rn(zi, safe_dot));
  const float phase_err =
      __fmul_rn(__shfl_sync(0xffffffffu, at, 0), p.inv_two_pi);
  float freq_err = __fdiv_rn(__shfl_sync(0xffffffffu, at, 1),
                             __fmul_rn(dt_eff, p.two_pi));
  const bool has_prev = prev_abs > 0.0f;
  const bool fll_on = c.state == PULL_IN && has_prev;
  freq_err = fll_on ? freq_err : 0.0f;

  // ---- loop filters (bandwidth scheduled by state) ----
  const bool narrow = c.state == NARROW_TRACK || c.ext_n > 1;
  const float pll_bw = narrow ? p.pll_bw_narrow : p.pll_bw;
  const float dll_bw = narrow ? p.dll_bw_narrow : p.dll_bw;
  const bool in_pullin = c.state == PULL_IN;
  const float fll_freq =
      fma32(__fmul_rn(dt_eff, p.fll_gain), freq_err, c.carrier_freq);
  // PLL3 with no FLL term: its two FLL terms are 0.0 * 0.0, added as + 0
  const float w0p = __fmul_rn(pll_bw, p.inv_pll_w0);
  const float w0p2 = __fmul_rn(w0p, w0p);
  const float w0p3 = __fmul_rn(w0p2, w0p);
  const float pll2 = __fadd_rn(
      c.pll2, __fmul_rn(dt_eff, __fadd_rn(__fmul_rn(w0p3, phase_err), 0.0f)));
  const float pll1 = __fadd_rn(
      c.pll1,
      __fmul_rn(dt_eff,
                __fadd_rn(__fadd_rn(pll2, __fmul_rn(__fmul_rn(w0p2, p.a3),
                                                    phase_err)),
                          0.0f)));
  const float pll_out =
      __fadd_rn(pll1, __fmul_rn(__fmul_rn(w0p, p.b3), phase_err));
  float new_pll1 = in_pullin ? fll_freq : pll1;
  float new_pll2 = in_pullin ? 0.0f : pll2;
  // DLL2
  const float w0 = __fmul_rn(dll_bw, p.inv_dll_w0);
  const float dll1 = __fadd_rn(
      c.dll1, __fmul_rn(__fmul_rn(dt_eff, __fmul_rn(w0, w0)), code_err));
  const float code_cmd =
      __fadd_rn(dll1, __fmul_rn(__fmul_rn(w0, p.a2), code_err));
  float new_carrier_freq = in_pullin ? fll_freq : pll_out;

  // ---- C/N0 and lock detectors ----
  const float a = p.cn0_alpha;
  const float qq = __fmul_rn(pq, pq);
  const float p2 = fma32(pr, pr, qq);
  float e_abs_i = c.e_abs_i, e_p2 = c.e_p2, e_mq = c.e_mq, e_pq = c.e_pq;
  if (boundary) {
    e_abs_i = fma32(a, __fsub_rn(fabsf(pr), e_abs_i), e_abs_i);
    e_p2 = fma32(a, __fsub_rn(p2, e_p2), e_p2);
    e_mq = fma32(a, __fsub_rn(fma32(pr, pr, -qq), e_mq), e_mq);
    e_pq = fma32(a, __fsub_rn(p2, e_pq), e_pq);
  }
  const float dt_cn0 = __fmul_rn((float)c.ext_n, dt);
  const float pd = __fmul_rn(e_abs_i, e_abs_i);
  const float pn = clamp_min_f(__fsub_rn(e_p2, pd), p.eps12);
  const float snr = __fdiv_rn(pd, pn);
  const float cn0_est = __fmul_rn(
      log10f(clamp_min_f(__fdiv_rn(snr, dt_cn0), p.eps12)), 10.0f);

  // ---- Kalman carrier tracking (the kKf variants) ----
  bool kf_on = false;
  float kf_dphi = 0.0f;
  float kf_p[9], kf_acc = 0.0f;
  if constexpr (kKf) {
    kf_on = boundary && c.state >= WIDE_TRACK;
    if (kf_on) {
      float f_kf;
      kf_step(p, c.kf_p, c.kf_acc, c.carrier_freq, phase_err, dt_eff,
              cn0_est, kf_p, f_kf, kf_acc, kf_dphi);
      if (!in_pullin) new_carrier_freq = f_kf;
      // keep the PLL carry synced so a fallback starts cleanly
      new_pll1 = new_carrier_freq;
      new_pll2 = 0.0f;
    }
  }

  const float doppler = __fsub_rn(new_carrier_freq, c.if_freq);
  const float new_code_freq =
      __fsub_rn(fma32(doppler, p.code_to_carrier, p.code_rate), code_cmd);
  const float lock_metric = __fdiv_rn(e_mq, clamp_min_f(e_pq, p.eps12));
  const bool warmed = c.ecount > 50;
  const bool fail_now = warmed && c.state >= WIDE_TRACK &&
                        (cn0_est < p.cn0_min || lock_metric < p.lock_min);
  const int new_lock_fail =
      boundary ? (fail_now ? c.lock_fail + 1 : max(c.lock_fail - 1, 0))
               : c.lock_fail;
  const bool loss = c.loss || new_lock_fail > p.max_lock_fail;

  // ---- state machine ----
  int eis = valid ? c.eis + 1 : c.eis;
  const bool promote_wide = c.state == PULL_IN && eis >= p.pull_in_epochs;
  const bool promote_narrow =
      c.state == WIDE_TRACK && eis >= p.wide_epochs;
  const int new_state =
      promote_wide ? WIDE_TRACK : (promote_narrow ? NARROW_TRACK : c.state);
  eis = (promote_wide || promote_narrow) ? 0 : eis;

  // ---- NCO phase / offset advance ----
  float tot = fma32(__fmul_rn(c.carrier_freq, p.inv_fs), n_samp_f, c.frac);
  // the KF's phase-error transfer: the NCO phase jumps by it
  if constexpr (kKf) tot = __fadd_rn(tot, kf_dphi);
  const float whole = floorf(tot);
  const float new_frac = __fsub_rn(tot, whole);
  const int new_cycles = c.cycles + (int)whole;
  const float new_rem = clamp_min_f(
      __fsub_rn(fma32(e.cps, n_samp_f, c.rem), p.code_len), 0.0f);
  const int new_offset = c.off + e.n_samp;

  // ---- the step's packed output row (pack_host_outputs' columns) ----
  if (row != nullptr) {
    const int dpi = kTaps ? (kPilot ? kTaps - 1 : pi) : p.data_prompt_index;
    row[0] = corr[2 * dpi];
    row[1] = corr[2 * dpi + 1];
    row[2] = c.rem;
    row[3] = c.code_freq;
    row[4] = c.carrier_freq;
    row[5] = c.frac;
    row[6] = cn0_est;
    row[7] = lock_metric;
    row[8] = vsel;
    row[9] = f_of(c.ecount);
    row[10] = f_of(c.off);
    row[11] = f_of(c.cycles);
  }

  // ---- the new carry: lane 0 writes it once every lane has read it ----
  __syncwarp();
  if (lane != 0) return;
  if (valid) {
    c.state = new_state;
    c.off = new_offset;
    c.rem = new_rem;
    c.frac = new_frac;
    c.cycles = new_cycles;
    c.eis = eis;
    c.ecount = c.ecount + 1;
  }
  if (boundary) {
    c.code_freq = new_code_freq;
    c.carrier_freq = new_carrier_freq;
    c.dll1 = dll1;
    c.pll1 = new_pll1;
    c.pll2 = new_pll2;
    c.prev_i = pr;
    c.prev_q = pq;
    c.e_abs_i = e_abs_i;
    c.e_p2 = e_p2;
    c.e_mq = e_mq;
    c.e_pq = e_pq;
    c.lock_fail = new_lock_fail;
    c.loss = loss;
  }
  if constexpr (kKf) {
    if (kf_on) {
      c.kf_acc = kf_acc;
#pragma unroll
      for (int i = 0; i < 9; ++i) c.kf_p[i] = kf_p[i];
    }
  }
#pragma unroll
  for (int k = 0; k < 2 * NT; ++k)
    if (kTaps || k < 2 * K) c.acc[k] = boundary ? 0.0f : acc[k];
  c.acc_dt = boundary ? 0.0f : acc_dt;
  c.acc_cnt = boundary ? 0 : acc_cnt;
}

template <bool kKf>
__device__ void load_carry(ChannelCarry<kKf>& c, const int* w, int n_taps) {
  c.active = w[W_ACTIVE];
  c.state = w[W_STATE];
  c.off = w[W_SAMPLE_OFFSET];
  c.rem = f_of(w[W_REM_CODE_PHASE]);
  c.code_freq = f_of(w[W_CODE_FREQ]);
  c.carrier_freq = f_of(w[W_CARRIER_FREQ]);
  c.frac = f_of(w[W_CARR_PHASE_FRAC]);
  c.cycles = w[W_CARR_PHASE_CYCLES];
  c.dll1 = f_of(w[W_DLL_ACC1]);
  c.pll1 = f_of(w[W_PLL_ACC1]);
  c.pll2 = f_of(w[W_PLL_ACC2]);
  c.prev_i = f_of(w[W_PREV_PROMPT_0]);
  c.prev_q = f_of(w[W_PREV_PROMPT_1]);
  c.e_abs_i = f_of(w[W_CN0_EMA_ABS_I]);
  c.e_p2 = f_of(w[W_CN0_EMA_P2]);
  c.e_mq = f_of(w[W_CN0_EMA_I2_MINUS_Q2]);
  c.e_pq = f_of(w[W_CN0_EMA_I2_PLUS_Q2]);
  c.eis = w[W_EPOCHS_IN_STATE];
  c.ecount = w[W_EPOCH_COUNT];
  c.lock_fail = w[W_LOCK_FAIL];
  c.loss = w[W_LOSS_OF_LOCK];
  c.ext_n = w[W_EXT_N];
  c.ext_anchor = w[W_EXT_ANCHOR];
  c.sec_len = w[W_SEC_LEN];
  c.sec_anchor = w[W_SEC_ANCHOR];
  c.acc_dt = f_of(w[W_ACC_DT]);
  c.acc_cnt = w[W_ACC_CNT];
  c.if_freq = f_of(w[W_IF_FREQ]);
  for (int k = 0; k < 2 * n_taps; ++k) c.acc[k] = f_of(w[W_ACC_CORR + k]);
  if constexpr (kKf) {
    c.kf_acc = f_of(w[W_KF_ACC]);
    for (int i = 0; i < 9; ++i)
      c.kf_p[i] = f_of(w[W_ACC_CORR + 2 * n_taps + i]);
  }
}

// Stores the fields the loop changes; the other words were copied already.
template <bool kKf>
__device__ void store_carry(const ChannelCarry<kKf>& c, int* w, int n_taps) {
  w[W_STATE] = c.state;
  w[W_SAMPLE_OFFSET] = c.off;
  w[W_REM_CODE_PHASE] = w_of(c.rem);
  w[W_CODE_FREQ] = w_of(c.code_freq);
  w[W_CARRIER_FREQ] = w_of(c.carrier_freq);
  w[W_CARR_PHASE_FRAC] = w_of(c.frac);
  w[W_CARR_PHASE_CYCLES] = c.cycles;
  w[W_DLL_ACC1] = w_of(c.dll1);
  w[W_PLL_ACC1] = w_of(c.pll1);
  w[W_PLL_ACC2] = w_of(c.pll2);
  w[W_PREV_PROMPT_0] = w_of(c.prev_i);
  w[W_PREV_PROMPT_1] = w_of(c.prev_q);
  w[W_CN0_EMA_ABS_I] = w_of(c.e_abs_i);
  w[W_CN0_EMA_P2] = w_of(c.e_p2);
  w[W_CN0_EMA_I2_MINUS_Q2] = w_of(c.e_mq);
  w[W_CN0_EMA_I2_PLUS_Q2] = w_of(c.e_pq);
  w[W_EPOCHS_IN_STATE] = c.eis;
  w[W_EPOCH_COUNT] = c.ecount;
  w[W_LOCK_FAIL] = c.lock_fail;
  w[W_LOSS_OF_LOCK] = c.loss;
  w[W_ACC_DT] = w_of(c.acc_dt);
  w[W_ACC_CNT] = c.acc_cnt;
  for (int k = 0; k < 2 * n_taps; ++k) w[W_ACC_CORR + k] = w_of(c.acc[k]);
  if constexpr (kKf) {
    w[W_KF_ACC] = w_of(c.kf_acc);
    for (int i = 0; i < 9; ++i)
      w[W_ACC_CORR + 2 * n_taps + i] = w_of(c.kf_p[i]);
  }
}

// Fetch this thread's samples of tile j of the window that starts at sample
// `off` of the chunk into its ring slot, asynchronously (8-byte cp.async per
// sample; the caller commits): for each row q of the tile, sample j * tile
// + q * GNSS_THREADS + lane into slot[q * lanes + threadIdx.x], below the
// tile's count (bounded by the window bound n_max and the chunk's end).
__device__ __forceinline__ void prefetch_tile(float2* slot,
                                              const float2* chunk,
                                              const TrackParams& p, int off,
                                              int j, int lane, int lanes) {
  const int first = j * p.tile;
  const int cnt =
      min(p.tile, min(p.n_max - first, p.length - off - first));
  const float2* src = chunk + off + first + lane;
  float2* dst = slot + threadIdx.x;
  for (int q = 0; q * GNSS_THREADS + lane < cnt; ++q)
    __pipeline_memcpy_async(dst + q * lanes, src + q * GNSS_THREADS,
                            sizeof(float2));
}

// kPilot: the taps read a [2, Lt] table by component (pilot tracking);
// without it every tap reads the one component, and the routing folds away.
// kTaps: the tap count (0: p.n_taps at run time). One cluster of
// p.cluster blocks per channel, GNSS_THREADS / p.cluster threads each.
template <bool kPilot, int kTaps, bool kKf>
__global__ void __launch_bounds__(GNSS_THREADS)
track_chunk_kernel(const TrackParams p, const float2* __restrict__ chunk,
                   const float* __restrict__ code_tables,
                   const float* __restrict__ sec_tables,
                   const int* __restrict__ carry_in, int* __restrict__ carry_out,
                   float* __restrict__ packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ChannelCarry<kKf> carry;
  __shared__ EpochPlan plan;
  // each local warp's row of 2K sums, double-buffered by step parity
  __shared__ float part[2][GNSS_WARPS][2 * GNSS_MAX_TAPS];
  __shared__ float corr[2 * GNSS_MAX_TAPS];
  __shared__ float taps[GNSS_MAX_TAPS];
  __shared__ int comp[GNSS_MAX_TAPS];

  cg::cluster_group cluster = cg::this_cluster();
  const int m = p.cluster;
  const int rank = m > 1 ? (int)cluster.block_rank() : 0;
  const int c = blockIdx.x / m;
  const int lanes = GNSS_THREADS / m;             // = blockDim.x
  const int lane_g = rank * lanes + (int)threadIdx.x;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int block_warps = lanes / 32;
  const int nt2 = 2 * (kTaps ? kTaps : p.n_taps);
  const int W = p.carry_width;
  const int T = p.tile;
  const int slot_len = T / m;
  // dynamic shared memory: [ring of 2 x tile / m float2][n_comp x table_len]
  float2* ring = reinterpret_cast<float2*>(smem);
  float* code = reinterpret_cast<float*>(ring + 2 * (size_t)slot_len);

  // stage the tables once per dispatch; block 0 copies the carry row
  // through
  const int table_words = p.n_comp * p.table_len;
  const float* table = code_tables + (size_t)c * table_words;
  for (int i = threadIdx.x; i < table_words; i += lanes) code[i] = table[i];
  if (rank == 0)
    for (int i = threadIdx.x; i < W; i += lanes)
      carry_out[(size_t)c * W + i] = carry_in[(size_t)c * W + i];
  if (threadIdx.x < GNSS_MAX_TAPS) {
    taps[threadIdx.x] = p.taps[threadIdx.x];
    comp[threadIdx.x] = p.tap_comp[threadIdx.x];
  }
  if (warp == 0) {
    ChannelCarry<kKf> cw;
    EpochPlan pw;
    load_carry(cw, carry_in + (size_t)c * W, p.n_taps);
    plan_epoch(cw, p, pw);
    if (wl == 0) {
      carry = cw;
      plan = pw;
    }
  }
  __syncthreads();
  if (K2_PARTS & K2_FILL) {
    prefetch_tile(ring, chunk, p, plan.off, 0, lane_g, lanes);
    __pipeline_commit();
  }
  const float* sec_row =
      sec_tables != nullptr ? sec_tables + (size_t)c * p.sec_stride : nullptr;

  int slot = 0;                           // ring slot of the tile in hand
  for (int s = 0; s < p.n_steps; ++s) {
    const int par = s & 1;
    const EpochPlan e = plan;
    const int hi = min(e.ns, e.cnt);
    const int n_tiles = max(1, (hi + T - 1) / T);
    const EpochNco nco{e.rem, e.cps, e.frac, e.step};
    EpochAcc acc;
    epoch_acc_zero(acc);
    for (int j = 0; j < n_tiles; ++j) {
      float2* cur = ring + (size_t)slot * slot_len;
      if (K2_PARTS & K2_FILL) {
        // fetch the tile after this one: the next of this epoch, else the
        // first of the next epoch, whose offset is known now; a thread
        // reads only the samples it fetched itself, so no block barrier
        float2* next = ring + (size_t)(slot ^ 1) * slot_len;
        bool issued = true;
        if (j + 1 < n_tiles)
          prefetch_tile(next, chunk, p, e.off, j + 1, lane_g, lanes);
        else if (s + 1 < p.n_steps)
          prefetch_tile(next, chunk, p, e.next_off, 0, lane_g, lanes);
        else
          issued = false;
        if (issued) {
          __pipeline_commit();
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
      }
      if (K2_PARTS & K2_ACCUMULATE)
        epoch_accumulate_any<kTaps, kPilot>(
            e.wrap, acc, cur + threadIdx.x, lanes, j * T + lane_g,
            min((j + 1) * T, hi), code, p.table_len, nco, taps, comp,
            p.n_taps, p.table_rate);
      slot ^= 1;
    }
    if (K2_PARTS & K2_REDUCE) {
      epoch_warp_reduce<kTaps>(acc, p.n_taps);
      if (wl == 0)
        for (int k = 0; k < nt2; ++k) part[par][warp][k] = acc.v[k];
    } else {
      // a timing build without the reduction: the sums stay live through
      // a global store that never happens
      float live = 0.f;
      for (int k = 0; k < nt2; ++k) live += acc.v[k];
      if (live == 1.2345e-38f) packed[0] = live;
    }
    if (m > 1)
      cluster.sync();                     // every block's rows are in place
    else
      __syncthreads();
    if (warp == 0) {
      // the 16 warp rows in warp order, wherever their block runs
      if ((K2_PARTS & K2_REDUCE) && wl < nt2) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < GNSS_WARPS; ++w) {
          float* row_w = &part[par][w % block_warps][wl];
          v = __fadd_rn(v, m > 1 ? *cluster.map_shared_rank(
                                       row_w, w / block_warps)
                                 : *row_w);
        }
        corr[wl] = v;
        // a timing build without the update keeps the sums live
        if (!(K2_PARTS & K2_UPDATE) && v == 1.2345e-38f) packed[0] = v;
      }
      __syncwarp();
      if (K2_PARTS & K2_UPDATE) {
        float* row = (rank == 0 && wl == 0)
                         ? packed + ((size_t)s * p.n_ch + c) * PACKED_COLS
                         : nullptr;
        update_epoch<kTaps, kPilot, kKf>(carry, p, e, corr, sec_row, row,
                                         wl);
        __syncwarp();                     // the new carry is in place
        EpochPlan pw;
        plan_epoch(carry, p, pw);
        if (wl == 0) plan = pw;
      }
    }
    __syncthreads();                      // publish the next epoch's plan
  }
  if (m > 1) cluster.sync();              // no block leaves while read

  // rebase the offsets for the next chunk; the loss flag on every row
  if (rank == 0) {
    if (threadIdx.x == 0) {
      if (carry.active) carry.off -= p.chunk_len;
      store_carry(carry, carry_out + (size_t)c * W, p.n_taps);
    }
    const float lol = carry.loss ? 1.0f : 0.0f;
    for (int s = threadIdx.x; s < p.n_steps; s += lanes)
      packed[((size_t)s * p.n_ch + c) * PACKED_COLS + 12] = lol;
  }
}

typedef void (*TrackKernel)(const TrackParams, const float2*, const float*,
                            const float*, const int*, int*, float*);

// The compiled variants: [KF][pilot][tap set], the tap sets of the
// receivers' configurations (3: E/P/L; 5: VEML; +1: the pilot's data
// prompt) and any other count at run time; the KF variants run the Kalman
// carrier update (p.carrier_kf).
#define K2_SETS(kf)                                                     \
  {{track_chunk_kernel<false, 3, kf>, track_chunk_kernel<false, 5, kf>, \
    track_chunk_kernel<false, 0, kf>},                                  \
   {track_chunk_kernel<true, 4, kf>, track_chunk_kernel<true, 6, kf>,   \
    track_chunk_kernel<true, 0, kf>}}
static const TrackKernel kVariants[2][2][3] = {K2_SETS(false), K2_SETS(true)};
#undef K2_SETS

static TrackKernel variant(const TrackParams& p) {
  const int pilot = p.n_comp == 2 ? 1 : 0;
  const int set = p.n_taps == 3 + pilot ? 0 : (p.n_taps == 5 + pilot ? 1 : 2);
  return kVariants[p.carrier_kf != 0][pilot][set];
}

static size_t dyn_smem(const TrackParams& p) {
  return 2 * (size_t)(p.tile / p.cluster) * sizeof(float2) +
         (size_t)p.n_comp * p.table_len * 4;
}

// Raise every variant's dynamic shared-memory limit to MAX_DYN_SMEM and
// allow clusters of up to K2_CLUSTER_MAX blocks, once per device, so
// launches of any size (a GPS group's and a Galileo group's, in any order
// on one stream) are covered.
static int prepare(void) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (raised[dev]) return 0;
  for (int v = 0; v < 12; ++v) {
    err = cudaFuncSetAttribute(kVariants[v / 6][v / 3 % 2][v % 3],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_DYN_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  raised[dev] = true;
  return 0;
}

// What the kernel does not take (cudaErrorInvalidValue), which the wrapper
// refuses first.
static int check(const TrackParams& p) {
  if (p.n_taps < 3 || p.n_taps > GNSS_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (p.n_comp < 1 || p.n_comp > 2) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < p.n_taps; ++k)
    if (p.tap_comp[k] < 0 || p.tap_comp[k] >= p.n_comp)
      return (int)cudaErrorInvalidValue;
  if (p.tile < GNSS_THREADS || p.tile > K2_TILE_MAX ||
      p.tile % GNSS_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  // m blocks of whole warps: m divides the 16 warps, at most 8
  if (p.cluster < 1 || p.cluster > K2_CLUSTER_MAX ||
      GNSS_WARPS % p.cluster != 0)
    return (int)cudaErrorInvalidValue;
  if (dyn_smem(p) > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  // a compiled tap set fixes the prompt taps (the main taps' middle; the
  // pilot's data prompt last)
  const int pilot = p.n_comp == 2 ? 1 : 0, main = p.n_taps - pilot;
  if (p.prompt_index != main / 2 ||
      p.data_prompt_index != (pilot ? main : main / 2))
    return (int)cudaErrorInvalidValue;
  return 0;
}

static cudaLaunchConfig_t launch_config(const TrackParams& p,
                                        cudaLaunchAttribute* attr,
                                        cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_ch * p.cluster, 1, 1);
  cfg.blockDim = dim3(GNSS_THREADS / p.cluster, 1, 1);
  cfg.dynamicSmemBytes = dyn_smem(p);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch: the whole dispatch for every channel, p.cluster blocks per
// channel in one cluster. `params` points at a host TrackParams;
// `sec_tables` may be null. Returns the CUDA error code (0 on success;
// cudaErrorInvalidValue for what the kernel does not take), the cluster
// launch's own included: a refused launch is reported, never retried with
// another m.
extern "C" int gnss_track_chunk(const void* params, const void* chunk,
                                const void* code_tables,
                                const void* sec_tables, const void* carry_in,
                                void* carry_out, void* packed, void* stream) {
  const TrackParams p = *(const TrackParams*)params;
  int err = check(p);
  if (err != 0) return err;
  if (p.n_ch == 0) return (int)cudaSuccess;
  err = prepare();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(p, &attr, (cudaStream_t)stream);
  err = (int)cudaLaunchKernelEx(&cfg, variant(p), p, (const float2*)chunk,
                                (const float*)code_tables,
                                (const float*)sec_tables, (const int*)carry_in,
                                (int*)carry_out, (float*)packed);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// How many clusters of p.cluster blocks the card can run at once for this
// dispatch's kernel variant and shared memory (cudaOccupancyMaxActiveClusters),
// into *out; the wrapper picks the cluster size with it. Returns the CUDA
// error code.
extern "C" int gnss_track_max_clusters(const void* params, int* out) {
  const TrackParams p = *(const TrackParams*)params;
  int err = check(p);
  if (err != 0) return err;
  err = prepare();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  TrackParams one = p;
  one.n_ch = 1;
  const cudaLaunchConfig_t cfg = launch_config(one, &attr, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, variant(p), &cfg);
}
