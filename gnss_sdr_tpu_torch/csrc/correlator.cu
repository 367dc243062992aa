// Epoch multicorrelator for Hopper (sm_90a): the CUDA port of the Pallas
// kernel gnss_sdr_tpu/ops/correlator_pallas.py:_kernel (wrapper
// pallas_epoch_correlate), itself the fused form of the reference's
// cpu_multicorrelator_real_codes.cc:105-168 (VOLK 32f_xn_resampler +
// 32fc_32f_rotator_dot_prod_32fc_xn).
//
// Per channel c, over n < min(n_samp[c], n_max):
//   x      = chunk[off_c + n]                                   (split IQ)
//   x     *= exp(-j 2 pi ((frac_c + step_c n) mod 1))           (carrier wipe)
//   out_k += x * code_c[floor((rem_c + cps_c n + tap_k) tr) mod Lt]
// giving out[C, K, 2].
//
// Design (right and simple first): one block per channel of GNSS_THREADS
// (512, epoch_correlate.cuh) threads. The block stages its channel's code
// table in dynamic shared memory (4 KB for
// L1 C/A, 40 KB for the longest 10230-chip code) where the per-sample
// gather is native; each thread strides over the window with 2K partial
// sums in registers; a warp-shuffle then shared-memory reduction finishes
// the block. The TPU kernel's padded window + mask becomes a loop bound.
//
// The per-epoch body (window loop, carrier wipe, code gather, reduction)
// lives in epoch_correlate.cuh, which the fused tracking kernel
// (tracking.cu) inlines too, so both run the same correlation code and
// roundings.
#include "epoch_correlate.cuh"

__global__ void __launch_bounds__(GNSS_THREADS)
epoch_correlate_kernel(const float* __restrict__ chunk, int chunk_len,
                       const int* __restrict__ offsets,
                       const int* __restrict__ n_samples, int n_max,
                       const float* __restrict__ code_tables, int table_len,
                       const float* __restrict__ rem_code_phases,
                       const float* __restrict__ code_phase_steps,
                       const float* __restrict__ carr_phase_fracs,
                       const float* __restrict__ carr_phase_steps,
                       const float* __restrict__ tap_offsets, int n_taps,
                       int table_rate, float* __restrict__ out) {
  extern __shared__ float code[];                 // [table_len]
  __shared__ EpochReduce red;

  const int c = blockIdx.x;
  const float* table = code_tables + (size_t)c * table_len;
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) code[i] = table[i];
  __syncthreads();

  const int off = offsets[c];
  // in-kernel bounds guard: only samples 0 <= off + n < chunk_len are read
  epoch_correlate_block(
      reinterpret_cast<const float2*>(chunk) + off, -off, chunk_len - off,
      min(n_samples[c], n_max), code, table_len, rem_code_phases[c],
      code_phase_steps[c], carr_phase_fracs[c], carr_phase_steps[c],
      tap_offsets, n_taps, table_rate, red, out + (size_t)c * 2 * n_taps);
}

extern "C" int gnss_epoch_correlate(
    const void* chunk, int chunk_len, const void* offsets,
    const void* n_samples, int n_max, const void* code_tables, int n_channels,
    int table_len, const void* rem_code_phases, const void* code_phase_steps,
    const void* carr_phase_fracs, const void* carr_phase_steps,
    const void* tap_offsets, int n_taps, int table_rate, void* out,
    void* stream) {
  if (n_taps < 1 || n_taps > GNSS_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (n_channels == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)table_len * sizeof(float);
  epoch_correlate_kernel<<<n_channels, GNSS_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const float*)chunk, chunk_len, (const int*)offsets,
      (const int*)n_samples, n_max, (const float*)code_tables, table_len,
      (const float*)rem_code_phases, (const float*)code_phase_steps,
      (const float*)carr_phase_fracs, (const float*)carr_phase_steps,
      (const float*)tap_offsets, n_taps, table_rate, (float*)out);
  return (int)cudaGetLastError();
}
