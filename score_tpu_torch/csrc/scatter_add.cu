// Row scatter-add: table[ids[i], :] += src[i, :] over a zeroed f32 [V, W]
// table. The backward of the row gather (gather.cu): the gradient of a
// table from the gradient of its gathered rows.
//
// Replaces the transpose of score_tpu/kernels/gather.py:gather_rows_pallas
// (and of the jnp.take of the JAX package's lookups), which the TPU runs as
// XLA's own scatter-add: the Pallas kernel has no backward of its own.
//
// Bound on the H100: bytes, and contention on repeated ids. Each source row
// is read once and added into its table row; there is no other
// arithmetic. The design:
//   * consecutive threads take consecutive VEC-float vectors of the flat
//     source (VEC = 4 where the row length and both base pointers allow,
//     else 2 or 1), so a warp reads one contiguous span;
//   * each vector goes into the table with one vector atomicAdd (float4 and
//     float2 atomics into global memory are native on sm_90): a few lanes a
//     row, f32 adds in L2;
//   * a vector of zeros is skipped. Masked neighbour slots carry id 0 and a
//     gradient of exact zeros, so the pad row, which would take a large
//     share of all adds, takes almost none. Skipping x + 0 changes no sum
//     (x + (-0) == x, and 0 + (-0) == +0 as index_add_ gives).
// The order of the adds to one row is not fixed, so float sums differ from
// the plain version's in the last bits; integer-valued sources are exact.
// Popular ids still contend; a sort- or warp-aggregated reduction is the
// next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool nonzero(float x) { return x != 0.f; }
__device__ __forceinline__ bool nonzero(float2 x) {
  return x.x != 0.f || x.y != 0.f;
}
__device__ __forceinline__ bool nonzero(float4 x) {
  return x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f;
}

template <typename Vec, typename Index>
__global__ void scatter_add_kernel(const Vec* __restrict__ src,
                                   const int32_t* __restrict__ ids,
                                   Vec* __restrict__ table, Index total,
                                   Index vecs_per_row) {
  const Index stride = (Index)gridDim.x * blockDim.x;
  for (Index g = (Index)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    const Vec x = src[g];
    if (!nonzero(x)) continue;
    const Index row = g / vecs_per_row;
    const Index col = g - row * vecs_per_row;
    atomicAdd(table + (Index)__ldg(ids + row) * vecs_per_row + col, x);
  }
}

template <typename Vec>
void launch(const float* src, const int32_t* ids, float* table,
            long long n_ids, long long vecs_per_row, long long table_vecs,
            cudaStream_t stream) {
  const long long total = n_ids * vecs_per_row;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  if (total < (1LL << 30) && table_vecs < (1LL << 31)) {
    scatter_add_kernel<Vec, int32_t><<<(unsigned)blocks, threads, 0, stream>>>(
        (const Vec*)src, ids, (Vec*)table, (int32_t)total,
        (int32_t)vecs_per_row);
  } else {
    scatter_add_kernel<Vec, int64_t><<<(unsigned)blocks, threads, 0, stream>>>(
        (const Vec*)src, ids, (Vec*)table, (int64_t)total,
        (int64_t)vecs_per_row);
  }
}

}  // namespace

// src [n_ids, W] f32, ids [n_ids] int32 in [0, num_rows), table
// [num_rows, W] f32 (zeroed by the caller). The vector is the widest of 4,
// 2 and 1 floats that W and both base pointers allow.
extern "C" int scatter_add_rows(const float* src, const int32_t* ids,
                                float* table, long long n_ids,
                                long long num_rows, long long W,
                                void* stream) {
  if (n_ids <= 0 || W <= 0) return 0;
  const uintptr_t a = (uintptr_t)src | (uintptr_t)table | (uintptr_t)(W * 4);
  const int vec = (a & 15u) == 0 ? 4 : (a & 7u) == 0 ? 2 : 1;
  const long long vpr = W / vec;
  const long long table_vecs = num_rows * vpr;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 4: launch<float4>(src, ids, table, n_ids, vpr, table_vecs, s); break;
    case 2: launch<float2>(src, ids, table, n_ids, vpr, table_vecs, s); break;
    case 1: launch<float>(src, ids, table, n_ids, vpr, table_vecs, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* scatter_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
