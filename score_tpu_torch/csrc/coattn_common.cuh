// Device helpers shared by the co-attention kernels (the forward in
// coattn_cand.cuh, the backward in coattn_bwd.cuh). The warp helpers lay
// a [d]-vector across a warp, lane l holding component l (d <= 32), as
// the backward does; the forward takes the conversions, kNeg and `fold`.
// The reductions take a width W (32 or 16): with 16, each half-warp
// reduces on its own.

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

template <int W = 32>
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int W = 32>
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  }
  return x;
}

// One step of the transposing butterfly: v holds 2H partial sums; lanes
// whose bit `o` is set keep the upper H, the others the lower H, and each
// adds its partner's copy of the half it keeps. Pairs (i, i + H) with
// i >= LIVE are known to be zero in every lane and cost no shuffle.
template <int H, int LIVE = H>
__device__ __forceinline__ void fold(float* v, int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if (i < LIVE) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    } else {
      v[i] = 0.f;
    }
  }
}

// Sums each of v[0..K) over the 32 lanes (K = 16 or 32; v is clobbered).
// Returns, in lane l, the sum of v[l / (32 / K)]. Only the first LIVE
// pairs of the first step (v[i], v[i + K/2]) may be non-zero, so a K = 32
// sum of two runs of LIVE values, at 0 and at 16, takes LIVE + 15
// shuffles; v[i] is not read where the pair is dead.
template <int K, int LIVE = K / 2>
__device__ __forceinline__ float transpose_sum(float* v, int lane) {
  if constexpr (K == 32) {
    fold<16, LIVE>(v, lane, 16);
    fold<8>(v, lane, 8);
    fold<4>(v, lane, 4);
    fold<2>(v, lane, 2);
    fold<1>(v, lane, 1);
  } else {
    fold<8, LIVE>(v, lane, 16);
    fold<4>(v, lane, 8);
    fold<2>(v, lane, 4);
    fold<1>(v, lane, 2);
    v[0] += __shfl_xor_sync(kFull, v[0], 1);
  }
  return v[0];
}

// Masked softmax across the warp (W = 32) or each half-warp (W = 16):
// lane j holds score s of row j and whether row j is valid. As the
// reference: invalid rows weigh 0, and rows none of which is valid give
// all zeros.
template <int W = 32>
__device__ __forceinline__ float lane_softmax(float s, bool valid) {
  const float mx = warp_max<W>(valid ? s : kNeg);
  const float e = valid ? expf(s - mx) : 0.f;
  return e / fmaxf(warp_sum<W>(e), 1e-20f);
}

}  // namespace
