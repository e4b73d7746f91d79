// Per-pair co-attention forward, sum, mean and max pools, in the
// candidates form: the user side Eu [B, T, n, d] is shared by C candidates
// Ei [B, C, T, m, d] and read in place, never tiled.
//
// Replaces score_tpu/kernels/coattn.py:_coattn_fwd_pallas (body
// _coattn_kernel), the forward of cross_coattn_pallas. With C == 1 it is
// that function; with C > 1 it is that function on the user side tiled C
// times, as score_tpu/nn/coattn.py feeds it.
//
// The kernel is coattn_cand.cuh's; its note gives the math (su/si for
// each pool, the exact zeros of a row with no valid entry), the bound on
// the H100 and the design. The sum pool is the candidates kernel's own
// instance, so pool 0 gives `cand_fwd`'s result. The mean divides the two
// opposite-side sums by their valid counts (not the target terms), in
// stage B for the user side and after the item loop for the item side.
// The max pool takes the relation matrix on tensor cores (m16n8k16 bf16
// with EuW split hi + lo for bf16 inputs, 3xTF32 m16n8k8 for f32), a warp
// a (b, c, t) unit.
//
// What held the first design back (one warp per (b, t) and 8 candidates,
// lane l holding component l; 8-16x the byte bound): shuffles. The max
// pool paid a 16-wide transposing butterfly, a 4-step row max and a
// 5-step warp sum for each valid user row and a broadcast and a warp sum
// for each valid item row, ~310 warp shuffles a unit; sum and mean paid a
// 5-step warp sum a row, 2-byte row loads a lane and 32 x n broadcast
// shuffles a warp to rebuild EuW, once per 8 candidates (per 2 at
// training's C = 2).
//
// ptxas (nvcc 12.9, sm_90a), registers (spill stores / loads, bytes) of
// the max instances, 16-byte path then scalar path (d * itemsize % 16 or
// an unaligned view): bf16 n, m <= 16: 128 (0/0), 128 (4/4); bf16 <= 32:
// 128 (120/140), 128 (140/180); f32 <= 16: 128 (20/32), 128 (12/16); f32
// <= 32: 128 (1048/1188), 128 (676/1456). The mean instances as the sum
// instances of coattn_cand.cu, within a few registers: 114-128, the bf16
// scalar ones with 12-20 B of spill stores.

#include "coattn_cand.cuh"

namespace {

template <typename T>
int dispatch_pool(int pool, const void* Eu, const void* Ei, const void* mu,
                  const void* mi, const float* Wr, const void* eu,
                  const void* ei, void* cu, void* ci, int B, int C, int Tn,
                  int n, int m, int d, int target_aware,
                  cudaStream_t stream) {
  if (pool == kSum) {
    return dispatch<T, kSum>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n,
                             m, d, target_aware, stream);
  }
  if (pool == kMean) {
    return dispatch<T, kMean>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n,
                              m, d, target_aware, stream);
  }
  return dispatch<T, kMax>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m,
                           d, target_aware, stream);
}

}  // namespace

// pool: 0 = sum, 1 = mean, 2 = max. dtype: 0 = float32, 1 = bfloat16 (Eu,
// Ei, eu, ei, cu and ci share it); Wr is f32; masks are bool bytes.
extern "C" int pair_fwd(const void* Eu, const void* Ei, const void* mu,
                        const void* mi, const float* Wr, const void* eu,
                        const void* ei, void* cu, void* ci, int B, int C,
                        int Tn, int n, int m, int d, int target_aware,
                        int pool, int dtype, void* stream) {
  if (d < 1 || d > 32 || n < 1 || n > 32 || m < 1 || m > 32 || dtype < 0 ||
      dtype > 1 || pool < 0 || pool > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * C * Tn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? dispatch_pool<float>(pool, Eu, Ei, mu, mi, Wr, eu, ei, cu, ci,
                                    B, C, Tn, n, m, d, target_aware, s)
             : dispatch_pool<__nv_bfloat16>(pool, Eu, Ei, mu, mi, Wr, eu, ei,
                                            cu, ci, B, C, Tn, n, m, d,
                                            target_aware, s);
}

extern "C" const char* coattn_pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
