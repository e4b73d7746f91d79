// Candidates-form co-attention backward, sum and mean pools: the gradients
// with respect to Eu, Ei, eu, ei and Wr. Included by coattn_cand_bwd.cu
// (sum pool, the VJP of coattn_cand.cu) and coattn_pair_bwd.cu (sum and
// mean, the VJP of coattn_pair.cu), which add their C entry points.
//
// Forward, per (b, c, t), with Wr reassociated onto the [d]-sized masked
// sums (the same function as score_tpu/kernels/coattn.py's EuW form:
// (Eu_j Wr) . Es == Eu_j . (Es Wr^T)); the mean pool divides each masked
// sum by its valid count, max(cnt, 1):
//   Em = sum_j mu_j Eu_j [/ cnt_u]   w = Em @ Wr      (+ eu_b  if target-aware)
//   Es = sum_k mi_k Ei_ck [/ cnt_i]  v = Es @ Wr^T    (+ ei_bc if target-aware)
//   a  = softmax_j(Eu_j . v * s | mu)    b = softmax_k(Ei_ck . w * s | mi)
//   cu = sum_j a_j Eu_j                  ci = sum_k b_k Ei_ck
// Backward, from dcu and dci (s = 1/sqrt(d)):
//   da_j = Eu_j . dcu      dsu = a (da - sum a da)     (likewise db, dsi)
//   dEu_j = sum_c [a_j dcu + s dsu_j v] + mu_j (dw @ Wr^T) [/ cnt_u]
//   dv    = s sum_j dsu_j Eu_j          dw = s sum_c sum_k dsi_k Ei_ck
//   dEi_k = b_k dci + s dsi_k w + mi_k (dv @ Wr) [/ cnt_i]
//   deu   = sum_t dw, dei_c = sum_t dv   (zero when not target-aware)
//   dWr   = sum_{b,t} [sum_c dv (x) Es + Em (x) dw]
// A masked row has a_j = dsu_j = mu_j = 0, so its gradient is exact zeros.
//
// Bound on the H100: bytes in principle (it reads Eu, Ei, dcu, dci once
// and writes dEu, dEi once, with a few hundred flops per row), but the
// TPU kernels' sequential grids, which carried dWr and the sums over t and
// c from one step to the next, have no counterpart here. The design:
//   * one warp owns one example b and loops over t and, inside, over c,
//     with lane l holding component l of every vector (d <= 32), so dEu
//     (summed over c), dw, deu (summed over t) and dei (summed over t, in
//     an f32 scratch row that only this warp touches) need no atomics;
//   * the forward is recomputed in registers; the softmax of a row runs
//     across lanes (lane j holds score j), so no score array is held;
//   * dWr: each warp adds its outer products into its own [d, d] slice of
//     shared memory (lane l owns column l: no bank conflicts, no atomics);
//     the block sums its slices in a fixed order into a per-block partial,
//     and a second small kernel sums the partials in a fixed order. The
//     result is the same from run to run.
// Parallelism is one warp per example, so this kernel wants B in the
// thousands, as training gives it.

#pragma once

#include "coattn_common.cuh"

namespace {

constexpr int kBwdWarpsPerBlock = 4;

template <typename T, int MAXK, bool kMean>
__global__ void __launch_bounds__(kBwdWarpsPerBlock * 32)
coattn_bwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                  const uint8_t* __restrict__ mu,
                  const uint8_t* __restrict__ mi,
                  const float* __restrict__ Wr, const T* __restrict__ eu,
                  const T* __restrict__ ei, const T* __restrict__ dcu,
                  const T* __restrict__ dci, T* __restrict__ dEu,
                  T* __restrict__ dEi, T* __restrict__ deu,
                  T* __restrict__ dei, float* __restrict__ dei_acc,
                  float* __restrict__ dWr_part, int B, int C, int Tn, int n,
                  int m, int d, int target_aware, float scale) {
  extern __shared__ float smem[];
  const int dd = d * d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sWr = smem;                       // Wr[e][l] at e*d + l
  float* sWrT = smem + dd;                 // Wr[l][e] at e*d + l
  float* sdW = smem + (2 + warp) * dd;     // this warp's dWr slice
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    const float x = Wr[i];
    sWr[i] = x;
    sWrT[(i % d) * d + i / d] = x;
  }
  for (int i = lane; i < dd; i += 32) sdW[i] = 0.f;
  __syncthreads();

  const bool act = lane < d;
  const long long b = (long long)blockIdx.x * kBwdWarpsPerBlock + warp;
  if (b < B) {  // no early return: the block syncs again below
    float deu_acc = 0.f;
    for (int t = 0; t < Tn; ++t) {
      const long long bt = b * Tn + t;
      const T* Eu_bt = Eu + bt * n * d;
      const unsigned mu_bits =
          __ballot_sync(kFull, lane < n && mu[bt * n + lane]);
      // the mean's 1 / max(count, 1); the sum pool never scales
      const float inv_u =
          kMean ? 1.0f / fmaxf((float)__popc(mu_bits), 1.f) : 1.0f;
      float eu_r[MAXK], dEu_r[MAXK];
      float em = 0.f;
#pragma unroll
      for (int j = 0; j < MAXK; ++j) {
        eu_r[j] = (((mu_bits >> j) & 1u) && act)
                      ? to_f32(Eu_bt[j * d + lane]) : 0.f;
        em += eu_r[j];
        dEu_r[j] = 0.f;
      }
      if (kMean) em *= inv_u;
      float w = 0.f;
      for (int e = 0; e < d; ++e) {
        const float s = __shfl_sync(kFull, em, e);
        if (act) w += s * sWr[e * d + lane];
      }
      if (target_aware && act) w += to_f32(eu[b * d + lane]);

      float dw = 0.f;
      for (int c = 0; c < C; ++c) {
        const long long bc = b * C + c;
        const long long bct = bc * Tn + t;
        const T* Ei_c = Ei + bct * m * d;
        const unsigned mi_bits =
            __ballot_sync(kFull, lane < m && mi[bct * m + lane]);
        const float inv_i =
            kMean ? 1.0f / fmaxf((float)__popc(mi_bits), 1.f) : 1.0f;
        float ei_r[MAXK];
        float es = 0.f;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          ei_r[k] = (((mi_bits >> k) & 1u) && act)
                        ? to_f32(Ei_c[k * d + lane]) : 0.f;
          es += ei_r[k];
        }
        if (kMean) es *= inv_i;
        float v = 0.f;
        for (int e = 0; e < d; ++e) {
          const float s = __shfl_sync(kFull, es, e);
          if (act) v += s * sWrT[e * d + lane];
        }
        if (target_aware && act) v += to_f32(ei[bc * d + lane]);
        const float g_cu = act ? to_f32(dcu[bct * d + lane]) : 0.f;
        const float g_ci = act ? to_f32(dci[bct * d + lane]) : 0.f;

        // scores and the weighted sums' gradients; lane j holds row j's
        float su = kNeg, da = 0.f, si = kNeg, db = 0.f;
#pragma unroll
        for (int j = 0; j < MAXK; ++j) {
          if ((mu_bits >> j) & 1u) {   // uniform across the warp
            const float s = warp_sum(eu_r[j] * v) * scale;
            const float g = warp_sum(eu_r[j] * g_cu);
            if (lane == j) { su = s; da = g; }
          }
        }
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          if ((mi_bits >> k) & 1u) {
            const float s = warp_sum(ei_r[k] * w) * scale;
            const float g = warp_sum(ei_r[k] * g_ci);
            if (lane == k) { si = s; db = g; }
          }
        }
        const float a = lane_softmax(su, (mu_bits >> lane) & 1u);
        const float bw = lane_softmax(si, (mi_bits >> lane) & 1u);
        const float dsu = a * (da - warp_sum(a * da));
        const float dsi = bw * (db - warp_sum(bw * db));

        // user rows: dEu_j += a_j dcu + s dsu_j v; dv = s sum_j dsu_j Eu_j
        float dv = 0.f;
#pragma unroll
        for (int j = 0; j < MAXK; ++j) {
          if ((mu_bits >> j) & 1u) {
            const float aj = __shfl_sync(kFull, a, j);
            const float gj = __shfl_sync(kFull, dsu, j);
            dEu_r[j] += aj * g_cu + scale * gj * v;
            dv += gj * eu_r[j];
          }
        }
        dv *= scale;
        // item rows: dw += s dsi_k Ei_k; ei_r[k] becomes b_k dci + s dsi_k w
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          if ((mi_bits >> k) & 1u) {
            const float bk = __shfl_sync(kFull, bw, k);
            const float gk = __shfl_sync(kFull, dsi, k);
            dw += scale * gk * ei_r[k];
            ei_r[k] = bk * g_ci + scale * gk * w;
          }
        }
        // through v = Es @ Wr^T: dEs = dv @ Wr, dWr[e][k] += dv_e Es_k
        float des = 0.f;
        for (int e = 0; e < d; ++e) {
          const float s = __shfl_sync(kFull, dv, e);
          if (act) {
            des += s * sWr[e * d + lane];
            sdW[e * d + lane] += s * es;
          }
        }
        if (kMean) des *= inv_i;   // through the mean's division
        if (act) {
          T* dEi_c = dEi + bct * m * d;
#pragma unroll
          for (int k = 0; k < MAXK; ++k) {
            if (k < m) {
              dEi_c[k * d + lane] =
                  from_f32<T>(((mi_bits >> k) & 1u) ? ei_r[k] + des : 0.f);
            }
          }
          if (target_aware) {
            float* acc = dei_acc + bc * d + lane;
            *acc = (t == 0 ? 0.f : *acc) + dv;
          }
        }
      }

      // through w = Em @ Wr: dEm = dw @ Wr^T, dWr[k][e] += Em_k dw_e
      deu_acc += dw;
      float dem = 0.f;
      for (int e = 0; e < d; ++e) {
        const float s = __shfl_sync(kFull, dw, e);
        const float x = __shfl_sync(kFull, em, e);
        if (act) {
          dem += s * sWrT[e * d + lane];
          sdW[e * d + lane] += x * dw;
        }
      }
      if (kMean) dem *= inv_u;
      if (act) {
        T* dEu_bt = dEu + bt * n * d;
#pragma unroll
        for (int j = 0; j < MAXK; ++j) {
          if (j < n) {
            dEu_bt[j * d + lane] =
                from_f32<T>(((mu_bits >> j) & 1u) ? dEu_r[j] + dem : 0.f);
          }
        }
      }
    }
    if (act) {
      deu[b * d + lane] = from_f32<T>(target_aware ? deu_acc : 0.f);
      for (int c = 0; c < C; ++c) {
        const long long i = (b * C + c) * d + lane;
        dei[i] = from_f32<T>(target_aware ? dei_acc[i] : 0.f);
      }
    }
  }

  __syncthreads();
  // the block's partial of dWr: its warps' slices in a fixed order
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    float s = 0.f;
    for (int w2 = 0; w2 < kBwdWarpsPerBlock; ++w2) {
      s += smem[(2 + w2) * dd + i];
    }
    dWr_part[(long long)blockIdx.x * dd + i] = s;
  }
}

// out[e] = sum_g part[g][e] over G partials, in a fixed order: 32 entries a
// block, 32 threads an entry, then the 32 sums in order.
__global__ void __launch_bounds__(1024)
sum_partials_kernel(const float* __restrict__ part, int G, int dd,
                    float* __restrict__ out) {
  __shared__ float red[32][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (e < dd) {
    for (int g = threadIdx.y; g < G; g += 32) s += part[(long long)g * dd + e];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < dd) {
    float tot = 0.f;
    for (int r = 0; r < 32; ++r) tot += red[r][threadIdx.x];
    out[e] = tot;
  }
}

// Number of per-block dWr partials the backward needs room for, d*d
// floats each.
inline int bwd_num_partials(int B) {
  return (B + kBwdWarpsPerBlock - 1) / kBwdWarpsPerBlock;
}

template <typename T, int MAXK, bool kMean>
void bwd_launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
                const float* Wr, const void* eu, const void* ei,
                const void* dcu, const void* dci, void* dEu, void* dEi,
                void* deu, void* dei, float* dei_acc, float* dWr_part,
                float* dWr, int B, int C, int Tn, int n, int m, int d,
                int target_aware, cudaStream_t stream) {
  const int blocks = bwd_num_partials(B);
  const size_t smem = (size_t)(2 + kBwdWarpsPerBlock) * d * d * sizeof(float);
  const float scale = 1.0f / sqrtf((float)d);
  coattn_bwd_kernel<T, MAXK, kMean>
      <<<blocks, kBwdWarpsPerBlock * 32, smem, stream>>>(
          (const T*)Eu, (const T*)Ei, (const uint8_t*)mu,
          (const uint8_t*)mi, Wr, (const T*)eu, (const T*)ei,
          (const T*)dcu, (const T*)dci, (T*)dEu, (T*)dEi, (T*)deu, (T*)dei,
          dei_acc, dWr_part, B, C, Tn, n, m, d, target_aware, scale);
  const int dd = d * d;
  sum_partials_kernel<<<(dd + 31) / 32, dim3(32, 32), 0, stream>>>(
      dWr_part, blocks, dd, dWr);
}

// dtype: 0 = float32, 1 = bfloat16 (Eu, Ei, eu, ei, dcu, dci and the
// gradients dEu, dEi, deu, dei share it). Wr and dWr are f32. dei_acc is
// f32 [B, C, d] scratch (unused when not target-aware) and dWr_part f32
// [bwd_num_partials(B), d, d] scratch. kMean: the mean pool, else the sum
// pool. Returns a CUDA error code.
template <bool kMean>
int bwd_entry(const void* Eu, const void* Ei, const void* mu, const void* mi,
              const float* Wr, const void* eu, const void* ei,
              const void* dcu, const void* dci, void* dEu, void* dEi,
              void* deu, void* dei, float* dei_acc, float* dWr_part,
              float* dWr, int B, int C, int Tn, int n, int m, int d,
              int target_aware, int dtype, void* stream) {
  if (d < 1 || d > 32 || n < 1 || n > 32 || m < 1 || m > 32 || B < 1 ||
      C < 1 || Tn < 1 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  // The row arrays are sized at compile time: the smallest size that
  // holds max(n, m) keeps registers low.
  const int k = n > m ? n : m;
#define COATTN_BWD_LAUNCH(T, K)                                              \
  bwd_launch<T, K, kMean>(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu, dEi, deu, \
                          dei, dei_acc, dWr_part, dWr, B, C, Tn, n, m, d,    \
                          target_aware, s)
  if (dtype == 0) {
    if (k <= 10) COATTN_BWD_LAUNCH(float, 10);   // the benchmark's fan-out
    else if (k <= 16) COATTN_BWD_LAUNCH(float, 16);
    else COATTN_BWD_LAUNCH(float, 32);
  } else {
    if (k <= 10) COATTN_BWD_LAUNCH(__nv_bfloat16, 10);
    else if (k <= 16) COATTN_BWD_LAUNCH(__nv_bfloat16, 16);
    else COATTN_BWD_LAUNCH(__nv_bfloat16, 32);
  }
#undef COATTN_BWD_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace
