// Candidates-form co-attention forward, sum pool (SCoRe's cross-neighbour
// co-attention in the form serving computes).
//
// Replaces the forward of score_tpu/kernels/coattn_cand.py:cross_coattn_cand
// (_cand_fwd, body _cand_fwd_kernel over _fwd_common).
//
// Math, for each (b, c, t), with the Wr product reassociated onto the
// [d]-sized masked sums so no [n, d] x [d, d] product is ever formed:
//   w    = (sum_j mu_j Eu_j) @ Wr            (+ eu_b       if target_aware)
//   v    = (sum_k mi_k Ei_ck) @ Wr^T         (+ ei_bc      if target_aware)
//   su_j = Eu_j . v / sqrt(d)     a = masked softmax of su over j (mask mu)
//   si_k = Ei_ck . w / sqrt(d)    b = masked softmax of si over k (mask mi)
//   cu   = sum_j a_j Eu_j         ci = sum_k b_k Ei_ck
// A row with no valid entry gives exact zeros, not NaN.
//
// Bound on the H100: bytes. Per (b, c, t) the kernel reads m*d Ei values
// and writes 2*d outputs; the arithmetic is about 4*(n+m)*d + 2*d*d flops,
// under 10 flops per byte at bf16, far below the card's ~295 flop/byte line.
// The design therefore reads each input once and keeps every intermediate
// in registers:
//   * one warp owns one (b, t) and a run of kCandPerWarp candidates; lane
//     l holds component l of every vector (d <= 32 is at most one warp
//     wide, so a d-dot is a 5-step shuffle reduction);
//   * the user side Eu[b, t] (n rows), its mask and w are loaded or
//     computed once per warp and reused for all of the warp's candidates;
//   * masks arrive as bytes and become a 32-bit ballot per row, so rows a
//     mask excludes are never read;
//   * each softmax is taken online (running max, sum and weighted sum), so
//     no score array is held: few registers, many warps in flight to hide
//     the latency of the row loads;
//   * Wr and Wr^T sit in shared memory, so both products read it without
//     bank conflicts.
// C is a runtime loop over the warp's candidates and a grid dimension
// across warps, so any candidate count runs through one build.

#include "coattn_common.cuh"

namespace {

constexpr int kCandPerWarp = 8;
constexpr int kWarpsPerBlock = 8;

template <typename T, int MAXK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cand_fwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                const uint8_t* __restrict__ mu, const uint8_t* __restrict__ mi,
                const float* __restrict__ Wr, const T* __restrict__ eu,
                const T* __restrict__ ei, T* __restrict__ cu,
                T* __restrict__ ci, int B, int C, int Tn, int n, int m, int d,
                int target_aware, float scale) {
  extern __shared__ float smem[];
  float* sWr = smem;           // Wr[e][l] at e*d + l
  float* sWrT = smem + d * d;  // Wr[l][e] at e*d + l
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const float x = Wr[i];
    sWr[i] = x;
    sWrT[(i % d) * d + i / d] = x;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const bool act = lane < d;
  const int nchunks = (C + kCandPerWarp - 1) / kCandPerWarp;
  const long long unit =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= (long long)B * Tn * nchunks) return;  // no block sync below
  const int chunk = (int)(unit % nchunks);
  const long long bt = unit / nchunks;  // b * Tn + t
  const int t = (int)(bt % Tn);
  const long long b = bt / Tn;

  // --- user side: once per warp ---
  const T* Eu_bt = Eu + bt * n * d;
  const unsigned mu_bits = __ballot_sync(kFull, lane < n && mu[bt * n + lane]);
  float eu_r[MAXK];
  float msum = 0.f;
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    eu_r[j] = (((mu_bits >> j) & 1u) && act)
                  ? to_f32(Eu_bt[j * d + lane]) : 0.f;
    msum += eu_r[j];
  }
  float w = 0.f;
  for (int e = 0; e < d; ++e) {
    const float s = __shfl_sync(kFull, msum, e);
    if (act) w += s * sWr[e * d + lane];
  }
  if (target_aware && act) w += to_f32(eu[b * d + lane]);

  // --- candidates of this warp ---
  const int c1 = min(C, (chunk + 1) * kCandPerWarp);
  for (int c = chunk * kCandPerWarp; c < c1; ++c) {
    const long long bct = ((long long)b * C + c) * Tn + t;
    const T* Ei_c = Ei + bct * m * d;
    const unsigned mi_bits =
        __ballot_sync(kFull, lane < m && mi[bct * m + lane]);
    // every valid row's load in flight at once, then the item softmax
    float ei_r[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      ei_r[k] = (((mi_bits >> k) & 1u) && act)
                    ? to_f32(Ei_c[k * d + lane]) : 0.f;
    }
    float isum = 0.f;
    OnlineSoftmax item;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if ((mi_bits >> k) & 1u) {   // uniform across the warp
        isum += ei_r[k];
        item.add(warp_sum(ei_r[k] * w) * scale, ei_r[k]);
      }
    }
    float v = 0.f;
    for (int e = 0; e < d; ++e) {
      const float s = __shfl_sync(kFull, isum, e);
      if (act) v += s * sWrT[e * d + lane];
    }
    if (target_aware && act) {
      v += to_f32(ei[((long long)b * C + c) * d + lane]);
    }
    OnlineSoftmax user;
#pragma unroll
    for (int j = 0; j < MAXK; ++j) {
      if ((mu_bits >> j) & 1u) {
        user.add(warp_sum(eu_r[j] * v) * scale, eu_r[j]);
      }
    }
    if (act) {
      cu[bct * d + lane] = from_f32<T>(user.result());
      ci[bct * d + lane] = from_f32<T>(item.result());
    }
  }
}

template <typename T, int MAXK>
void launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
            const float* Wr, const void* eu, const void* ei, void* cu,
            void* ci, int B, int C, int Tn, int n, int m, int d,
            int target_aware, cudaStream_t stream) {
  const long long nchunks = (C + kCandPerWarp - 1) / kCandPerWarp;
  const long long units = (long long)B * Tn * nchunks;
  const long long blocks = (units + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = 2 * (size_t)d * d * sizeof(float);
  const float scale = 1.0f / sqrtf((float)d);
  cand_fwd_kernel<T, MAXK><<<(unsigned)blocks, kWarpsPerBlock * 32, smem,
                             stream>>>(
      (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi, Wr,
      (const T*)eu, (const T*)ei, (T*)cu, (T*)ci, B, C, Tn, n, m, d,
      target_aware, scale);
}

// The row arrays are sized at compile time: the smallest size that holds
// max(n, m) keeps registers low, and so keeps more warps and loads in
// flight.
template <typename T>
void dispatch(const void* Eu, const void* Ei, const void* mu, const void* mi,
              const float* Wr, const void* eu, const void* ei, void* cu,
              void* ci, int B, int C, int Tn, int n, int m, int d,
              int target_aware, cudaStream_t stream) {
  const int k = n > m ? n : m;
  if (k <= 10) {   // the benchmark's fan-out
    launch<T, 10>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,
                  target_aware, stream);
  } else if (k <= 16) {
    launch<T, 16>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,
                  target_aware, stream);
  } else {
    launch<T, 32>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,
                  target_aware, stream);
  }
}

}  // namespace

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
  if (dtype == 0) {
    dispatch<float>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,
                    target_aware, s);
  } else {
    dispatch<__nv_bfloat16>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n,
                            m, d, target_aware, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* coattn_cand_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
