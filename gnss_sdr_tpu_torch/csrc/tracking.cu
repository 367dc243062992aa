// Fused tracking kernel for Hopper (sm_90a), K2: the whole tracking loop of
// one dispatch in one launch. It replaces the JAX package's device program
// for a chunk, the lax.scan of `step` in gnss_sdr_tpu/receiver/tracking.py:
// 432-632, with the Pallas multicorrelator correlator_pallas.py:70 inlined
// (epoch_correlate.cuh, the body K1 runs too). Its plain version is the
// eager loop of gnss_sdr_tpu_torch/receiver/tracking.py:track_chunk.
//
// Design: one thread block per channel, a loop over the dispatch's n_steps
// code epochs inside the block. Per step:
//   1. the block correlates the epoch window against K code taps
//      (epoch_correlate.cuh), streaming the window through shared memory in
//      tiles: every thread strides over each tile and keeps its 2K partial
//      sums in registers from tile to tile; the block reduction runs once
//      per epoch;
//   2. one thread (thread 0) runs the scalar loop update on the carry,
//      which lives in shared memory: secondary-code wipe and coherent
//      accumulation, EMLP / Costas / FLL discriminators, DLL2 / PLL3 loop
//      filters with the FLL in pull-in, C/N0 and the lock metric, the
//      lock-fail counter and loss latch, the PULL_IN -> WIDE -> NARROW
//      state machine and the NCO advance; it writes the step's row of the
//      packed [S, C, 13] host outputs (pack_host_outputs' layout) and
//      publishes the next epoch's NCO state behind one block barrier.
// At the end it rebases sample_offset by -chunk_len for active channels,
// writes the loss flag into column 12 of every row and stores the carry.
//
// What bounds it on an H100: not bytes and not FLOPs. A 100 ms GPS L1 chunk
// is 1.6 MB of samples read through the 50 MB L2 and ~0.2 MFLOP per channel
// per step; the time is the chain of n_steps dependent steps, each a
// window pass of ~2000 (GPS L1, 2 MSps) to ~16,000 (Galileo E1, 4 MSps)
// samples over GNSS_THREADS threads (a few serial sincosf per thread), a
// block reduction, a scalar update of ~150 dependent float ops on one
// thread, and a few block barriers. What the design does about it:
//   - one launch per dispatch instead of ~231 eager operations per step;
//   - the code table (both components of a [2, Lt] table under pilot
//     tracking: 64 KB for E1-B + E1-C) is staged in shared memory once per
//     dispatch, not once per epoch;
//   - the window is read through a ring of two tiles of `tile` samples
//     (p.tile: n_max rounded up to a multiple of GNSS_THREADS, at most
//     K2_TILE_MAX = 4096), filled with cp.async one tile ahead: the next
//     tile of this epoch, or after the last one the first tile of the next
//     epoch (its offset offset + n_samp is known before this epoch's
//     correlation starts), so every load overlaps a tile's correlation and
//     the loop update. Shared memory is 2 x tile float2 (at most 64 KB)
//     plus the tables, whatever the window length: E1-B + E1-C at 4 MSps
//     (n_max 16,064) takes 128 KB, GPS L1 at 2 MSps 44 KB. Tiles start at
//     multiples of GNSS_THREADS from the window start, so each thread meets
//     its samples in the order of one pass over the whole window and the
//     sums keep the plain version's bits;
//   - the scalar update runs on one thread, not on every thread, and
//     channels run in parallel blocks, so the time per chunk hardly grows
//     with the channel count until the blocks fill the 132 SMs.
// Tensor cores do not apply: the product is [K <= 8, N] x [N, 2].
//
// Rounding. The kernel follows its plain version on the card op for op, and
// on an H100 with PyTorch 2.11 gives its bits over 1602 steps: the eager
// loop's integer fields are floors and ceils of float sums, and its PLL /
// DLL loops turn a last-bit difference per step into more than 1e-4 within
// ~1600 steps. So:
//   - the correlation is epoch_correlate.cuh, whose bits the plain
//     correlator repeats on the card (ops/correlator.py:_block_sum);
//   - every float op of the update is an intrinsic that states its rounding
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), as each of PyTorch's
//     separate elementwise kernels rounds, so nvcc contracts nothing; the
//     library functions (hypotf, atanf, log10f, sinf, cosf) are built with
//     nvcc's default flags, as PyTorch's own kernels are (never
//     --use_fast_math, never -fmad=false, which would change them);
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
#include <cuda_pipeline.h>

#include "epoch_correlate.cuh"

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
  W_ACC_CORR  // then 2K words of acc_corr, then 9 of kf_p (passed through)
};

#define PACKED_COLS 13
#define PULL_IN 1
#define WIDE_TRACK 2
#define NARROW_TRACK 3
#define MAX_DYN_SMEM (227 * 1024 - 4096)
// the window ring's tile length bound [samples] (ops/tracking_kernel.py
// TILE_MAX): two tiles of float2 take at most 64 KB
#define K2_TILE_MAX 4096

// Static configuration of one dispatch (tracking_kernel.py:_Params mirrors
// it field for field: 4-byte ints, then 4-byte floats, the taps' offsets
// and the taps' table components). n_taps counts every tap, the data prompt
// of pilot tracking included; table_len is one component's length and
// n_comp the components (1, or 2 under pilot tracking: pilot, data).
struct TrackParams {
  int n_ch, n_steps, n_max, chunk_len, length, table_len, table_rate, n_taps;
  int prompt_index, data_prompt_index, sec_stride, pull_in_epochs;
  int wide_epochs, max_lock_fail, carry_width, n_comp, tile;
  float inv_fs, code_len, min_cps, emlp_scale, inv_two_pi, two_pi, fll_gain;
  float code_to_carrier, code_rate, pll_bw, pll_bw_narrow, dll_bw;
  float dll_bw_narrow, inv_pll_w0, inv_dll_w0, a3, b3, a2, cn0_alpha;
  float cn0_min, lock_min, eps20, eps12;
  float taps[GNSS_MAX_TAPS];
  int tap_comp[GNSS_MAX_TAPS];
};

struct Carry {
  int active, state, off, cycles, eis, ecount, lock_fail, loss;
  int ext_n, ext_anchor, sec_len, sec_anchor, acc_cnt;
  float rem, code_freq, carrier_freq, frac, dll1, pll1, pll2;
  float prev_i, prev_q, e_abs_i, e_p2, e_mq, e_pq, acc_dt, if_freq;
  float acc[2 * GNSS_MAX_TAPS];
};

// The NCO state of the next epoch, published to the block.
struct EpochPlan {
  int n_samp, valid, off, ns, cnt, next_off;
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

// The start of an epoch: sample count, validity and NCO steps (tracking.py
// track_chunk, the first lines of each step).
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
}

// The loop update of one epoch on the correlation `corr` [K][2]: writes the
// step's packed output row and advances the carry.
__device__ void update_epoch(Carry& c, const TrackParams& p,
                             const EpochPlan& e, const float* corr,
                             const float* sec_row, float* row) {
  const bool valid = e.valid;
  const int K = p.n_taps;
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
  float acc[2 * GNSS_MAX_TAPS];
  for (int k = 0; k < 2 * K; ++k) {
    const float w = sec_row != nullptr ? __fmul_rn(corr[k], chip) : corr[k];
    acc[k] = __fadd_rn(c.acc[k], __fmul_rn(w, vsel));
  }
  const float acc_dt = __fadd_rn(c.acc_dt, valid ? dt : 0.0f);
  const int acc_cnt = c.acc_cnt + (valid ? 1 : 0);
  const int rel = floor_mod(eidx - c.ext_anchor, max(c.ext_n, 1));
  const bool boundary = valid && rel == c.ext_n - 1;
  const float dt_eff = acc_dt;

  const int pi = p.prompt_index;
  const float pr = acc[2 * pi], pq = acc[2 * pi + 1];

  // ---- discriminators ----
  const float ea = hypotf(acc[2 * (pi - 1)], acc[2 * (pi - 1) + 1]);
  const float la = hypotf(acc[2 * (pi + 1)], acc[2 * (pi + 1) + 1]);
  const float code_err = __fmul_rn(
      __fdiv_rn(__fsub_rn(ea, la), clamp_min_f(__fadd_rn(ea, la), p.eps20)),
      p.emlp_scale);
  const float safe_i = fabsf(pr) < p.eps20 ? p.eps20 : pr;
  const float phase_err = __fmul_rn(atanf(__fdiv_rn(pq, safe_i)),
                                    p.inv_two_pi);
  // z = prompt * conj(prev_prompt), as c10::complex's a*c - b*d, a*d + b*c
  // compile (the first product of each pair fused)
  const float zr = __fmaf_rn(pr, c.prev_i, -__fmul_rn(pq, -c.prev_q));
  const float zi = __fmaf_rn(pr, -c.prev_q, __fmul_rn(pq, c.prev_i));
  const float safe_dot = fabsf(zr) < p.eps20 ? p.eps20 : zr;
  float freq_err = __fdiv_rn(atanf(__fdiv_rn(zi, safe_dot)),
                             __fmul_rn(dt_eff, p.two_pi));
  const bool has_prev = hypotf(c.prev_i, c.prev_q) > 0.0f;
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
  const float new_pll1 = in_pullin ? fll_freq : pll1;
  const float new_pll2 = in_pullin ? 0.0f : pll2;
  // DLL2
  const float w0 = __fmul_rn(dll_bw, p.inv_dll_w0);
  const float dll1 = __fadd_rn(
      c.dll1, __fmul_rn(__fmul_rn(dt_eff, __fmul_rn(w0, w0)), code_err));
  const float code_cmd =
      __fadd_rn(dll1, __fmul_rn(__fmul_rn(w0, p.a2), code_err));
  const float new_carrier_freq = in_pullin ? fll_freq : pll_out;

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
  const float tot =
      fma32(__fmul_rn(c.carrier_freq, p.inv_fs), n_samp_f, c.frac);
  const float whole = floorf(tot);
  const float new_frac = __fsub_rn(tot, whole);
  const int new_cycles = c.cycles + (int)whole;
  const float new_rem = clamp_min_f(
      __fsub_rn(fma32(e.cps, n_samp_f, c.rem), p.code_len), 0.0f);
  const int new_offset = c.off + e.n_samp;

  // ---- the step's packed output row (pack_host_outputs' columns) ----
  const int dpi = p.data_prompt_index;
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

  // ---- the new carry ----
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
  for (int k = 0; k < 2 * K; ++k) c.acc[k] = boundary ? 0.0f : acc[k];
  c.acc_dt = boundary ? 0.0f : acc_dt;
  c.acc_cnt = boundary ? 0 : acc_cnt;
}

__device__ void load_carry(Carry& c, const int* w, int n_taps) {
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
}

// Stores the fields the loop changes; the other words were copied already.
__device__ void store_carry(const Carry& c, int* w, int n_taps) {
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
}

// Copy samples [j * tile, j * tile + cnt) of the window that starts at
// sample `off` of the chunk into `dst`, asynchronously (8-byte cp.async per
// sample), with cnt bounded by the tile, the window bound n_max and the
// chunk's end; the caller commits.
__device__ __forceinline__ void prefetch_tile(float2* dst,
                                              const float2* chunk,
                                              const TrackParams& p, int off,
                                              int j) {
  const int first = j * p.tile;
  const int cnt =
      min(p.tile, min(p.n_max - first, p.length - off - first));
  for (int n = threadIdx.x; n < cnt; n += GNSS_THREADS)
    __pipeline_memcpy_async(dst + n, chunk + off + first + n, sizeof(float2));
}

// kPilot: the taps read a [2, Lt] table by component (pilot tracking);
// without it every tap reads the one component, and the routing folds away
template <bool kPilot>
__global__ void __launch_bounds__(GNSS_THREADS)
track_chunk_kernel(const TrackParams p, const float2* __restrict__ chunk,
                   const float* __restrict__ code_tables,
                   const float* __restrict__ sec_tables,
                   const int* __restrict__ carry_in, int* __restrict__ carry_out,
                   float* __restrict__ packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Carry carry;
  __shared__ EpochPlan plan;
  __shared__ EpochReduce red;
  __shared__ float corr[2 * GNSS_MAX_TAPS];
  __shared__ float taps[GNSS_MAX_TAPS];
  __shared__ int comp[GNSS_MAX_TAPS];

  const int c = blockIdx.x;
  const int W = p.carry_width;
  const int T = p.tile;
  // dynamic shared memory: [ring of 2 x tile float2][n_comp x table_len]
  float2* ring = reinterpret_cast<float2*>(smem);
  float* code = reinterpret_cast<float*>(ring + 2 * (size_t)T);

  // stage the tables once per dispatch; copy the carry row through
  const int table_words = p.n_comp * p.table_len;
  const float* table = code_tables + (size_t)c * table_words;
  for (int i = threadIdx.x; i < table_words; i += GNSS_THREADS)
    code[i] = table[i];
  for (int i = threadIdx.x; i < W; i += GNSS_THREADS)
    carry_out[(size_t)c * W + i] = carry_in[(size_t)c * W + i];
  if (threadIdx.x < GNSS_MAX_TAPS) {
    taps[threadIdx.x] = p.taps[threadIdx.x];
    comp[threadIdx.x] = p.tap_comp[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    load_carry(carry, carry_in + (size_t)c * W, p.n_taps);
    plan_epoch(carry, p, plan);
  }
  __syncthreads();
  prefetch_tile(ring, chunk, p, plan.off, 0);
  __pipeline_commit();
  const float* sec_row =
      sec_tables != nullptr ? sec_tables + (size_t)c * p.sec_stride : nullptr;

  int slot = 0;                           // ring slot of the tile in hand
  for (int s = 0; s < p.n_steps; ++s) {
    const int hi = min(plan.ns, plan.cnt);
    const int n_tiles = max(1, (hi + T - 1) / T);
    EpochAcc acc;
    epoch_acc_zero(acc);
    for (int j = 0; j < n_tiles; ++j) {
      // fetch the tile after this one: the next of this epoch, else the
      // first of the next epoch, whose offset is known now
      float2* next = ring + (size_t)(slot ^ 1) * T;
      bool issued = true;
      if (j + 1 < n_tiles)
        prefetch_tile(next, chunk, p, plan.off, j + 1);
      else if (s + 1 < p.n_steps)
        prefetch_tile(next, chunk, p, plan.next_off, 0);
      else
        issued = false;
      if (issued) {
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();                    // this tile is in place
      epoch_accumulate(acc, ring + (size_t)slot * T, j * T, j * T,
                       min((j + 1) * T, hi), code, p.table_len, plan.rem,
                       plan.cps, plan.frac, plan.step, taps,
                       kPilot ? comp : nullptr, p.n_taps, p.table_rate);
      slot ^= 1;
      if (j + 1 < n_tiles) __syncthreads();   // the slot read is refilled next
    }
    epoch_reduce(acc, p.n_taps, red, corr);
    __syncthreads();                      // corr is complete
    if (threadIdx.x == 0) {
      float* row = packed + ((size_t)s * p.n_ch + c) * PACKED_COLS;
      update_epoch(carry, p, plan, corr, sec_row, row);
      plan_epoch(carry, p, plan);
    }
    __syncthreads();                      // publish the next epoch's plan
  }

  // rebase the offsets for the next chunk; the loss flag on every row
  if (threadIdx.x == 0) {
    if (carry.active) carry.off -= p.chunk_len;
    store_carry(carry, carry_out + (size_t)c * W, p.n_taps);
  }
  const float lol = carry.loss ? 1.0f : 0.0f;
  for (int s = threadIdx.x; s < p.n_steps; s += GNSS_THREADS)
    packed[((size_t)s * p.n_ch + c) * PACKED_COLS + 12] = lol;
}

// One launch: the whole dispatch for every channel. `params` points at a
// host TrackParams; `sec_tables` may be null. Returns the CUDA error code
// (0 on success; cudaErrorInvalidValue for what the kernel does not take,
// which the wrapper refuses first). The block's dynamic shared-memory limit
// is raised once per device to MAX_DYN_SMEM, so launches of any size (a
// GPS group's and a Galileo group's, in any order on one stream) are
// covered.
extern "C" int gnss_track_chunk(const void* params, const void* chunk,
                                const void* code_tables,
                                const void* sec_tables, const void* carry_in,
                                void* carry_out, void* packed, void* stream) {
  typedef void (*Kernel)(const TrackParams, const float2*, const float*,
                         const float*, const int*, int*, float*);
  static bool raised[64] = {};
  const Kernel variants[2] = {track_chunk_kernel<false>,
                              track_chunk_kernel<true>};
  const TrackParams p = *(const TrackParams*)params;
  const Kernel kernel = variants[p.n_comp == 2 ? 1 : 0];
  if (p.n_taps < 3 || p.n_taps > GNSS_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (p.n_comp < 1 || p.n_comp > 2) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < p.n_taps; ++k)
    if (p.tap_comp[k] < 0 || p.tap_comp[k] >= p.n_comp)
      return (int)cudaErrorInvalidValue;
  if (p.tile < GNSS_THREADS || p.tile > K2_TILE_MAX ||
      p.tile % GNSS_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  if (p.n_ch == 0) return (int)cudaSuccess;
  const size_t smem = 2 * (size_t)p.tile * sizeof(float2) +
                      (size_t)p.n_comp * p.table_len * 4;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    for (int v = 0; v < 2; ++v) {
      err = cudaFuncSetAttribute(variants[v],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_DYN_SMEM);
      if (err != cudaSuccess) return (int)err;
    }
    raised[dev] = true;
  }
  kernel<<<p.n_ch, GNSS_THREADS, smem, (cudaStream_t)stream>>>(
      p, (const float2*)chunk, (const float*)code_tables,
      (const float*)sec_tables, (const int*)carry_in, (int*)carry_out,
      (float*)packed);
  return (int)cudaGetLastError();
}
