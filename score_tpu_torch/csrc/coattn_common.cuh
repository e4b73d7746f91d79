// Device helpers shared by the co-attention kernels (coattn_cand.cu,
// coattn_pair.cu and the backward in coattn_bwd.cuh). Every one of them
// lays a [d]-vector across a warp, lane l holding component l (d <= 32).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Online masked softmax-weighted sum over rows x_j with scores s_j: after
// all valid rows, result() is sum_j softmax(s)_j x_j. The same value as the
// reference's where(-1e9) / subtract-max / exp * mask / divide by
// max(sum, 1e-20); with no valid row, acc = sum = 0 and the result is 0.
struct OnlineSoftmax {
  float mx = kNeg, sum = 0.f, acc = 0.f;
  __device__ __forceinline__ void add(float s, float x) {
    const float m_new = fmaxf(mx, s);
    const float r = __expf(mx - m_new);  // rescales what came before
    const float e = __expf(s - m_new);
    sum = sum * r + e;
    acc = acc * r + e * x;
    mx = m_new;
  }
  __device__ __forceinline__ float result() const {
    return acc * (1.0f / fmaxf(sum, 1e-20f));
  }
};

// Masked softmax across the warp: lane j holds score s of row j and
// whether row j is valid. As the reference: invalid rows weigh 0, and a
// warp with no valid row gives all zeros.
__device__ __forceinline__ float lane_softmax(float s, bool valid) {
  const float mx = warp_max(valid ? s : kNeg);
  const float e = valid ? expf(s - mx) : 0.f;
  return e / fmaxf(warp_sum(e), 1e-20f);
}

}  // namespace
