// Candidates-form co-attention forward, sum pool (SCoRe's cross-neighbour
// co-attention in the form serving computes).
//
// Replaces the forward of score_tpu/kernels/coattn_cand.py:cross_coattn_cand
// (_cand_fwd, body _cand_fwd_kernel over _fwd_common).
//
// The kernel is coattn_cand.cuh's, which coattn_pair.cu shares for the
// mean and max pools; its note gives the math, the bound on the H100 and
// the design. This file launches its sum-pool instances. With the Wr
// product reassociated onto the [d]-sized masked sums:
//   w    = (sum_j mu_j Eu_j) @ Wr            (+ eu_b       if target_aware)
//   v    = (sum_k mi_k Ei_ck) @ Wr^T         (+ ei_bc      if target_aware)
//   su_j = Eu_j . v / sqrt(d)     si_k = Ei_ck . w / sqrt(d)
//
// What held the first design back (one warp per (b, t) and 8 candidates,
// lane l holding component l; 7.8x the byte bound): instruction issue and
// latency, not bytes: a row load moved 2 bytes a lane, every score was a
// 5-step shuffle butterfly, the d x d product v = isum @ Wr^T took 32
// broadcast shuffles, all 32 lanes computed the same exponentials, and
// every warp redid the user side of its (b, t). The 4-lane groups of the
// header's design remove each of these.
//
// ptxas (nvcc 12.9, sm_90a), registers of the 8 instances (T, 16-byte
// path, v per unit then EuW staged), as coattn_pair.cu's build of the same
// instances prints them: bf16 vector 128 and 125, f32 vector 121 and 121,
// f32 scalar 128 and 128, none spilling; bf16 scalar (d*2 % 16 != 0 or an
// unaligned view) 128 and 128 with 20 and 12 B of spill stores.

#include "coattn_cand.cuh"

// dtype: 0 = float32, 1 = bfloat16 (Eu, Ei, eu, ei, cu and ci share it).
extern "C" int cand_fwd(const void* Eu, const void* Ei, const void* mu,
                        const void* mi, const float* Wr, const void* eu,
                        const void* ei, void* cu, void* ci, int B, int C,
                        int Tn, int n, int m, int d, int target_aware,
                        int dtype, void* stream) {
  if (d < 1 || d > 32 || n < 1 || n > 32 || m < 1 || m > 32 || dtype < 0 ||
      dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * C * Tn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? dispatch<float, kSum>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C,
                                     Tn, n, m, d, target_aware, s)
             : dispatch<__nv_bfloat16, kSum>(Eu, Ei, mu, mi, Wr, eu, ei, cu,
                                             ci, B, C, Tn, n, m, d,
                                             target_aware, s);
}

extern "C" const char* coattn_cand_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
