// Candidates-form co-attention backward, sum pool: the gradients of
// coattn_cand.cu's forward with respect to Eu, Ei, eu, ei and Wr.
//
// Replaces score_tpu/kernels/coattn_cand.py:_cand_bwd (body
// _cand_bwd_kernel over _fwd_common), the fused VJP of cross_coattn_cand.
// The kernel, its math, what bounds it on the H100 and its design are in
// coattn_bwd.cuh, which coattn_pair_bwd.cu shares.

#include "coattn_bwd.cuh"

// Number of per-block dWr partials cand_bwd needs room for, d*d floats each.
extern "C" int cand_bwd_num_partials(int B) { return bwd_num_partials(B); }

// dtype: 0 = float32, 1 = bfloat16 (Eu, Ei, eu, ei, dcu, dci and the
// gradients dEu, dEi, deu, dei share it). Wr and dWr are f32. dei_acc is
// f32 [B, C, d] scratch (unused when not target-aware) and dWr_part f32
// [cand_bwd_num_partials(B), d, d] scratch. B, C and T must be >= 1.
extern "C" int cand_bwd(const void* Eu, const void* Ei, const void* mu,
                        const void* mi, const float* Wr, const void* eu,
                        const void* ei, const void* dcu, const void* dci,
                        void* dEu, void* dEi, void* deu, void* dei,
                        float* dei_acc, float* dWr_part, float* dWr, int B,
                        int C, int Tn, int n, int m, int d, int target_aware,
                        int dtype, void* stream) {
  return bwd_entry</*kMean=*/false>(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                                     dEu, dEi, deu, dei, dei_acc, dWr_part,
                                     dWr, B, C, Tn, n, m, d, target_aware,
                                     dtype, stream);
}

extern "C" const char* coattn_cand_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
