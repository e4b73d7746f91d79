// Per-pair co-attention backward, sum and mean pools: the gradients of
// coattn_pair.cu's forward with respect to Eu, Ei, eu, ei and Wr, in the
// candidates form (the user side shared by C candidates).
//
// Replaces score_tpu/kernels/coattn.py:_coattn_bwd_pallas (body
// _coattn_bwd_kernel), the fused VJP of cross_coattn_pallas for pool in
// ('sum', 'mean'). The TPU kernel tiles the user side C times and
// recomputes EuW = Eu Wr per pair; its dWr accumulated across the
// sequential grid, and the caller summed the C copies' dEu and deu. Here
// one warp owns an example and walks its C candidates, so the sums over c
// and t happen in registers, and dWr goes through per-block partials and a
// fixed-order second pass (the same from run to run). The kernel, its math
// (Wr reassociated onto the [d]-sized masked sums, the mean's counts),
// what bounds it and its design are in coattn_bwd.cuh, shared with the
// candidates-form sum-pool backward.

#include "coattn_bwd.cuh"

// Number of per-block dWr partials pair_bwd needs room for, d*d floats each.
extern "C" int pair_bwd_num_partials(int B) { return bwd_num_partials(B); }

// pool: 0 = sum, 1 = mean. dtype: 0 = float32, 1 = bfloat16 (Eu, Ei, eu,
// ei, dcu, dci and the gradients dEu, dEi, deu, dei share it). Wr and dWr
// are f32. dei_acc is f32 [B, C, d] scratch (unused when not target-aware)
// and dWr_part f32 [pair_bwd_num_partials(B), d, d] scratch. B, C and T
// must be >= 1.
extern "C" int pair_bwd(const void* Eu, const void* Ei, const void* mu,
                        const void* mi, const float* Wr, const void* eu,
                        const void* ei, const void* dcu, const void* dci,
                        void* dEu, void* dEi, void* deu, void* dei,
                        float* dei_acc, float* dWr_part, float* dWr, int B,
                        int C, int Tn, int n, int m, int d, int target_aware,
                        int pool, int dtype, void* stream) {
  if (pool == 1) {
    return bwd_entry<true>(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu, dEi,
                           deu, dei, dei_acc, dWr_part, dWr, B, C, Tn, n, m,
                           d, target_aware, dtype, stream);
  }
  if (pool != 0) return (int)cudaErrorInvalidValue;
  return bwd_entry<false>(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu, dEi,
                          deu, dei, dei_acc, dWr_part, dWr, B, C, Tn, n, m, d,
                          target_aware, dtype, stream);
}

extern "C" const char* coattn_pair_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
