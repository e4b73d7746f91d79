// Per-pair co-attention forward, sum, mean and max pools, in the
// candidates form: the user side Eu [B, T, n, d] is shared by C candidates
// Ei [B, C, T, m, d] and read in place, never tiled.
//
// Replaces score_tpu/kernels/coattn.py:_coattn_fwd_pallas (body
// _coattn_kernel), the forward of cross_coattn_pallas. With C == 1 it is
// that function; with C > 1 it is that function on the user side tiled C
// times, as score_tpu/nn/coattn.py feeds it.
//
// Math, for each (b, c, t), s = 1/sqrt(d), EuW = Eu Wr ([n, d]):
//   sum/mean: Es = sum_k mi_k Ei_ck, Ew = sum_j mu_j EuW_j, each divided
//             by max(valid count, 1) for the mean;
//             su_j = s EuW_j . Es       si_k = s Ei_ck . Ew
//   max:      M_jk = s EuW_j . Ei_ck over the valid (j, k) pairs;
//             su_j = max_k M_jk, or 0 if no k is valid;
//             si_k = max_j M_jk, or 0 if no j is valid
//   target-aware: su_j += s Eu_j . ei_bc,  si_k += s Ei_ck . eu_b
//   a = masked softmax of su (mask mu), b = masked softmax of si (mask mi)
//   cu = sum_j a_j Eu_j,  ci = sum_k b_k Ei_ck
// A row with no valid entry gives exact zeros, not NaN.
//
// Bound on the H100: at the serving shape (16 users x 4096 candidates, bf16)
// bytes, ~460 MB at 3.35 TB/s, most of it the Ei rows, once EuW is computed
// once per (b, t): the TPU kernel recomputes EuW for every pair because it
// tiles the user side, and that product is ~20k of the ~29k f32 operations
// a pair costs at d = 32, n = m = 10, which would make the kernel bound by
// operations instead. The design:
//   * one warp owns one (b, t) and a run of kCandPerWarp candidates; lane
//     l holds component l of every vector (d <= 32), so a d-dot is a
//     shuffle reduction;
//   * the user side Eu[b, t], its mask, EuW (n rows, by shuffles against Wr
//     in shared memory) and, for sum/mean, Ew are made once per warp and
//     reused for all the warp's candidates; warps of one (b, t) are
//     neighbours in the grid, so the rows come from DRAM about once;
//   * masks arrive as bytes and become a 32-bit ballot per row, so masked
//     rows are never read;
//   * each softmax is taken online (running max, sum and weighted sum): no
//     score array is held;
//   * sum/mean fold the target term into the same reduction
//     (su_j = s sum_l (EuW_jl Es_l + Eu_jl ei_l)): one warp sum per row;
//   * max: the m dot products of one row j, M_j0 .. M_j(m-1), are reduced
//     together by a transposing butterfly (K values across 32 lanes in
//     K - 1 shuffles rather than 5 K), after which lane l holds M_jk for
//     k = l / (32 / K); the row max is a few more shuffles, and each lane
//     keeps the running column max of its k, so the [n, m] relation matrix
//     is never stored.
// C is a runtime loop over a warp's candidates and a grid dimension
// across warps, so any candidate count runs through one build.

#include "coattn_common.cuh"

namespace {

constexpr int kCandPerWarp = 8;
constexpr int kWarpsPerBlock = 8;
enum Pool { kSum = 0, kMean = 1, kMax = 2 };

template <typename T, int MAXK, int POOL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pair_fwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                const uint8_t* __restrict__ mu, const uint8_t* __restrict__ mi,
                const float* __restrict__ Wr, const T* __restrict__ eu,
                const T* __restrict__ ei, T* __restrict__ cu,
                T* __restrict__ ci, int B, int C, int Tn, int n, int m, int d,
                int target_aware, float scale) {
  // the butterfly's width: MAXK values padded to a power of two >= 16
  constexpr int K = MAXK <= 16 ? 16 : 32;
  extern __shared__ float sWr[];   // Wr[e][l] at e*d + l
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) sWr[i] = Wr[i];
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
  float eu_r[MAXK], euw_r[MAXK];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    eu_r[j] = (((mu_bits >> j) & 1u) && act)
                  ? to_f32(Eu_bt[j * d + lane]) : 0.f;
    euw_r[j] = 0.f;
  }
  // EuW_j = Eu_j @ Wr for the valid rows (masked rows stay 0)
  for (int e = 0; e < d; ++e) {
    const float wr = act ? sWr[e * d + lane] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXK; ++j) {
      if ((mu_bits >> j) & 1u) {   // uniform across the warp
        euw_r[j] += __shfl_sync(kFull, eu_r[j], e) * wr;
      }
    }
  }
  const float eu_l = (target_aware && act) ? to_f32(eu[b * d + lane]) : 0.f;
  // sum/mean: w = Ew (+ eu), so si_k = s Ei_k . w in one reduction
  float w = 0.f;
  if (POOL != kMax) {
#pragma unroll
    for (int j = 0; j < MAXK; ++j) w += euw_r[j];
    if (POOL == kMean) w *= 1.0f / fmaxf((float)__popc(mu_bits), 1.f);
    w += eu_l;
  }

  // --- candidates of this warp ---
  const int c1 = min(C, (chunk + 1) * kCandPerWarp);
  for (int c = chunk * kCandPerWarp; c < c1; ++c) {
    const long long bct = ((long long)b * C + c) * Tn + t;
    const T* Ei_c = Ei + bct * m * d;
    const unsigned mi_bits =
        __ballot_sync(kFull, lane < m && mi[bct * m + lane]);
    // every valid row's load in flight at once
    float ei_r[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      ei_r[k] = (((mi_bits >> k) & 1u) && act)
                    ? to_f32(Ei_c[k * d + lane]) : 0.f;
    }
    const float ei_l =
        (target_aware && act)
            ? to_f32(ei[((long long)b * C + c) * d + lane]) : 0.f;
    OnlineSoftmax user, item;

    if (POOL != kMax) {
      float es = 0.f;
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        if ((mi_bits >> k) & 1u) {
          es += ei_r[k];
          item.add(warp_sum(ei_r[k] * w) * scale, ei_r[k]);
        }
      }
      if (POOL == kMean) es *= 1.0f / fmaxf((float)__popc(mi_bits), 1.f);
#pragma unroll
      for (int j = 0; j < MAXK; ++j) {
        if ((mu_bits >> j) & 1u) {
          user.add(warp_sum(euw_r[j] * es + eu_r[j] * ei_l) * scale,
                   eu_r[j]);
        }
      }
    } else {
      // lane l holds row k = l / (32 / K) of the relation matrix
      const int kl = lane / (32 / K);
      const bool k_ok = kl < m && ((mi_bits >> kl) & 1u);
      float col = kNeg;   // running max over j of M_j,kl
#pragma unroll
      for (int j = 0; j < MAXK; ++j) {
        if ((mu_bits >> j) & 1u) {
          float su = 0.f;   // no valid k: 0, as the reference
          if (mi_bits) {
            float p[K];
#pragma unroll
            for (int k = 0; k < K; ++k) p[k] = 0.f;
#pragma unroll
            for (int k = 0; k < MAXK; ++k) p[k] = euw_r[j] * ei_r[k];
            const float mjk = transpose_sum<K>(p, lane) * scale;
            if (k_ok) col = fmaxf(col, mjk);
            float x = k_ok ? mjk : kNeg;
#pragma unroll
            for (int o = 32 / K; o < 32; o <<= 1) {
              x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
            }
            su = x;
          }
          if (target_aware) su += warp_sum(eu_r[j] * ei_l) * scale;
          user.add(su, eu_r[j]);
        }
      }
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        if ((mi_bits >> k) & 1u) {
          const float cm = __shfl_sync(kFull, col, k * (32 / K));
          float si = mu_bits ? cm : 0.f;   // no valid j: 0, as the reference
          if (target_aware) si += warp_sum(ei_r[k] * eu_l) * scale;
          item.add(si, ei_r[k]);
        }
      }
    }
    if (act) {
      cu[bct * d + lane] = from_f32<T>(user.result());
      ci[bct * d + lane] = from_f32<T>(item.result());
    }
  }
}

template <typename T, int MAXK, int POOL>
void launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
            const float* Wr, const void* eu, const void* ei, void* cu,
            void* ci, int B, int C, int Tn, int n, int m, int d,
            int target_aware, cudaStream_t stream) {
  const long long nchunks = (C + kCandPerWarp - 1) / kCandPerWarp;
  const long long units = (long long)B * Tn * nchunks;
  const long long blocks = (units + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)d * d * sizeof(float);
  const float scale = 1.0f / sqrtf((float)d);
  pair_fwd_kernel<T, MAXK, POOL>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, smem, stream>>>(
          (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi,
          Wr, (const T*)eu, (const T*)ei, (T*)cu, (T*)ci, B, C, Tn, n, m, d,
          target_aware, scale);
}

// The row arrays are sized at compile time: the smallest size that holds
// max(n, m) keeps registers low, and so keeps more warps and loads in
// flight.
template <typename T, int POOL>
void dispatch(const void* Eu, const void* Ei, const void* mu, const void* mi,
              const float* Wr, const void* eu, const void* ei, void* cu,
              void* ci, int B, int C, int Tn, int n, int m, int d,
              int target_aware, cudaStream_t stream) {
  const int k = n > m ? n : m;
  if (k <= 10) {   // the benchmark's fan-out
    launch<T, 10, POOL>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m,
                        d, target_aware, stream);
  } else if (k <= 16) {
    launch<T, 16, POOL>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m,
                        d, target_aware, stream);
  } else {
    launch<T, 32, POOL>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m,
                        d, target_aware, stream);
  }
}

template <typename T>
void dispatch_pool(int pool, const void* Eu, const void* Ei, const void* mu,
                   const void* mi, const float* Wr, const void* eu,
                   const void* ei, void* cu, void* ci, int B, int C, int Tn,
                   int n, int m, int d, int target_aware,
                   cudaStream_t stream) {
  if (pool == kSum) {
    dispatch<T, kSum>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,
                      target_aware, stream);
  } else if (pool == kMean) {
    dispatch<T, kMean>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,
                       target_aware, stream);
  } else {
    dispatch<T, kMax>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,
                      target_aware, stream);
  }
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
  if (dtype == 0) {
    dispatch_pool<float>(pool, Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn,
                         n, m, d, target_aware, s);
  } else {
    dispatch_pool<__nv_bfloat16>(pool, Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B,
                                 C, Tn, n, m, d, target_aware, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* coattn_pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
