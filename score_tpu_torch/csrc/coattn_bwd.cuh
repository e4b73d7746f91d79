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
// Replaces score_tpu/kernels/coattn_cand.py:_cand_bwd (body
// _cand_bwd_kernel; sum pool) and score_tpu/kernels/coattn.py:
// _coattn_bwd_pallas (body _coattn_bwd_kernel; sum and mean pools). The
// TPU kernels' sequential grids, which carried dWr and the sums over t and
// c from one step to the next, have no counterpart here.
//
// Bound on the H100: bytes in principle (Eu, Ei, dcu, dci read once, dEu,
// dEi written once: 0.038 ms at the training shape, B=4096 C=2 T=9
// n=m=10 d=32 bf16), but each warp's chain of dependent shuffles, shared
// loads and global loads sets the time, at 16 warps a SM (128 registers):
// 0.149 ms by CUDA graph on an H100 SXM at 700 W, 3.9x the bound (this
// design's predecessor: 0.451 ms; chip_ab_coattn.py). The design:
//   * one warp owns one example b and loops over t and, inside, over c
//     (a unit is one (b, c, t)), with lane l holding component l of every
//     vector (d <= 32), so dEu (summed over c), dw, deu (summed over t)
//     and dei (summed over t, in an f32 scratch row that only this warp
//     touches) need no atomics; the forward is recomputed in registers;
//   * scores and their gradients: each lane forms its partial products for
//     every row at once and two transposing butterflies reduce them (user
//     rows in lanes 0-15, item rows in lanes 16-31 while both sides have
//     <= 16 rows), so lane j ends holding row j's score and gradient and
//     each half-warp takes its softmax on its own;
//   * the d x d products read Wr and Wr^T from shared memory as lane l's
//     own padded row (8 16-byte loads, no bank conflict), against the
//     vector being multiplied staged in a per-warp shared row (8
//     broadcast loads); the softmax rows (a_j, dsu_j, b_j, dsi_j) are
//     staged too, so no loop over rows or components branches or shuffles;
//   * dWr: both outer products add to column `lane`, so each warp keeps
//     its share in 32 registers; at the end the block adds its warps'
//     shares in a fixed order into a per-block partial, and a second small
//     kernel sums the partials in a fixed order: the same from run to run;
//   * d = 32, the benchmark's width, has instances of its own (offsets and
//     bounds fold into the instructions), and the next unit's item rows
//     and mask are prefetched into L1 while the current one computes.
// MIO instructions a unit (shuffles and shared-memory accesses, about one
// a clock an SM) at the training shape, counted in the SASS of the bf16
// 10-row instance (with C=2 a unit carries half its (b, t)'s terms):
// ~620 before (230 butterfly shuffles in 40 warp sums and two softmaxes,
// ~120 broadcast shuffles, ~110 scalar shared loads and ~35 stores in the
// two products and the dWr updates, and ~120 for the (b, t) terms); ~130
// after (62 shuffles, 42 16-byte shared loads and 4 stores in the unit,
// and ~21 for the (b, t) terms), plus ~12 local-memory accesses of spills.
// ptxas (nvcc 12.9, sm_90a), registers and spill stores / loads in bytes,
// sum | mean pool: 10 rows, d = 32: bf16 128, 100/80 | 128, 28/40; f32
// 128, 204/160 | 128, 60/76. 10 rows, any d: 128, 20/44 | 128, none.
// 16 rows: 128 registers, 92-220 B. 32 rows: 236-237, none.
// Parallelism is one warp per example, so this kernel wants B in the
// thousands, as training gives it.

#pragma once

#include "coattn_common.cuh"

namespace {

constexpr int kBwdWarpsPerBlock = 4;
// Row stride of the padded Wr copies in shared memory: 36 floats put the
// 16-byte loads of 8 neighbouring lanes (one shared-memory wavefront) on
// 8 distinct 4-bank groups.
constexpr int kWrStride = 36;

// sum_e x[e] M[e] over e < 32, with x staged in shared memory (every lane
// reads the same 16 bytes: a broadcast) and M the lane's own padded row;
// four partial sums keep the dependent chain short.
__device__ __forceinline__ float row_dot(const float* __restrict__ M,
                                         const float* __restrict__ x) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 c = reinterpret_cast<const float4*>(M)[q];
    const float4 b = reinterpret_cast<const float4*>(x)[q];
    s[0] += b.x * c.x;
    s[1] += b.y * c.y;
    s[2] += b.z * c.z;
    s[3] += b.w * c.w;
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// acc[e] += x[e] * y for e < 32, x staged in shared memory (broadcast).
__device__ __forceinline__ void outer_add(float* acc,
                                          const float* __restrict__ x,
                                          float y) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 b = reinterpret_cast<const float4*>(x)[q];
    acc[4 * q] += b.x * y;
    acc[4 * q + 1] += b.y * y;
    acc[4 * q + 2] += b.z * y;
    acc[4 * q + 3] += b.w * y;
  }
}

// Writes each lane's x to slot `lane` of the warp's shared row, once every
// lane has finished reading the row's previous contents.
__device__ __forceinline__ void stage(float* row, int lane, float x) {
  __syncwarp();
  row[lane] = x;
  __syncwarp();
}

// Asks for the `count` elements at p to be brought into L1 without
// waiting, one 128-byte line a lane (count * sizeof(T) <= 4096).
template <typename T>
__device__ __forceinline__ void prefetch_block(const T* p, int count,
                                               int lane) {
  const char* line = (const char*)p + lane * 128;
  if (lane * 128 < count * (int)sizeof(T)) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(line));
  }
}

// kD: the width d where > 0, else read from d_in. Up to 16 rows, 4 blocks
// a SM (128 registers): on the card, 3 (168 registers, no spills) ran
// 1.3x slower and 5 (96, more spills) 1.2x slower.
template <typename T, int MAXK, bool kMean, int kD>
__global__ void __launch_bounds__(kBwdWarpsPerBlock * 32, MAXK <= 16 ? 4 : 1)
coattn_bwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                  const uint8_t* __restrict__ mu,
                  const uint8_t* __restrict__ mi,
                  const float* __restrict__ Wr, const T* __restrict__ eu,
                  const T* __restrict__ ei, const T* __restrict__ dcu,
                  const T* __restrict__ dci, T* __restrict__ dEu,
                  T* __restrict__ dEi, T* __restrict__ deu,
                  T* __restrict__ dei, float* __restrict__ dei_acc,
                  float* __restrict__ dWr_part, int B, int C, int Tn, int n,
                  int m, int d_in, int target_aware, float scale) {
  // the width, a compile-time constant where kD > 0 (the row offsets and
  // loop bounds then fold into the instructions)
  const int d = kD > 0 ? kD : d_in;
  // Rows of both sides share each butterfly when neither has more than
  // 16: lane j < 16 holds user row j, lane 16 + k item row k.
  constexpr bool kPacked = MAXK <= 16;
  // Wr in two padded copies, zero outside [d, d]: lane l's coefficients
  // of w = Em Wr and dEs = dv Wr are sWrT[l][e] = Wr[e][l], those of
  // v = Es Wr^T and dEm = dw Wr^T are sWr[l][e] = Wr[l][e].
  __shared__ __align__(16) float sWrT[32 * kWrStride];
  __shared__ __align__(16) float sWr[32 * kWrStride];
  // per warp: the vector being broadcast (Es, then dv, then dw), Em, and
  // the softmax rows (a_j, dsu_j, b_j, dsi_j) at row j
  __shared__ __align__(16) float sVec[kBwdWarpsPerBlock][32];
  __shared__ __align__(16) float sEm[kBwdWarpsPerBlock][32];
  __shared__ float4 sRow[kBwdWarpsPerBlock][32];
  for (int i = threadIdx.x; i < 32 * kWrStride; i += blockDim.x) {
    const int l = i / kWrStride, e = i % kWrStride;
    const bool in = l < d && e < d;
    sWrT[i] = in ? Wr[e * d + l] : 0.f;
    sWr[i] = in ? Wr[l * d + e] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* rowT = sWrT + lane * kWrStride;
  const float* row = sWr + lane * kWrStride;
  float* vec = sVec[warp];
  float* em_s = sEm[warp];
  float4* rows = sRow[warp];
  // this warp's share of dWr, acc[r] = dWr[r][lane]: both outer products
  // add to column `lane`, so it stays in registers until the end
  float acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;

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
      stage(em_s, lane, em);   // lanes >= d hold 0, as every staged vector
      float w = row_dot(rowT, em_s);
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
        // While this unit computes, bring the next one's item rows and
        // mask (and, before a new t, its user rows) into L1. Issued after
        // this unit's loads, so they do not queue ahead of them.
        if (c + 1 < C || t + 1 < Tn) {
          const int c2 = c + 1 < C ? c + 1 : 0;
          const int t2 = c + 1 < C ? t : t + 1;
          const long long bct2 = (b * C + c2) * Tn + t2;
          prefetch_block(Ei + bct2 * m * d, m * d, lane);
          prefetch_block(mi + bct2 * m, m, lane);
          if (c2 == 0) prefetch_block(Eu + (b * Tn + t2) * n * d, n * d, lane);
        }
        stage(vec, lane, es);
        float v = row_dot(row, vec);
        if (target_aware && act) v += to_f32(ei[bc * d + lane]);
        const float g_cu = act ? to_f32(dcu[bct * d + lane]) : 0.f;
        const float g_ci = act ? to_f32(dci[bct * d + lane]) : 0.f;

        // Scores and the weighted sums' gradients, every row's at once, by
        // transposing butterflies; then the softmaxes, whose rows go to
        // shared memory for the broadcasts below (the last unit's reads of
        // them ended before its stage of dv). Masked rows have zero
        // partials and weigh 0, so a_j = dsu_j = 0 there.
        if constexpr (kPacked) {
          // one butterfly for both sides' scores, one for their gradients;
          // each half-warp then takes its own softmax
          float p[32];
#pragma unroll
          for (int j = 0; j < MAXK; ++j) {
            p[j] = eu_r[j] * v;
            p[16 + j] = ei_r[j] * w;
          }
          const float s = transpose_sum<32, MAXK>(p, lane) * scale;
#pragma unroll
          for (int j = 0; j < MAXK; ++j) {
            p[j] = eu_r[j] * g_cu;
            p[16 + j] = ei_r[j] * g_ci;
          }
          const float g = transpose_sum<32, MAXK>(p, lane);
          const unsigned bits = mu_bits | (mi_bits << 16);
          const float a = lane_softmax<16>(s, (bits >> lane) & 1u);
          const float ds = a * (g - warp_sum<16>(a * g));
          // lane j < 16: (a_j, dsu_j) of row j; lane 16 + k: (b_k, dsi_k)
          reinterpret_cast<float2*>(rows)[2 * (lane & 15) + (lane >> 4)] =
              make_float2(a, ds);
        } else {
          float p[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) p[j] = eu_r[j] * v;
          const float su = transpose_sum<32>(p, lane) * scale;
#pragma unroll
          for (int j = 0; j < 32; ++j) p[j] = eu_r[j] * g_cu;
          const float da = transpose_sum<32>(p, lane);
#pragma unroll
          for (int k = 0; k < 32; ++k) p[k] = ei_r[k] * w;
          const float si = transpose_sum<32>(p, lane) * scale;
#pragma unroll
          for (int k = 0; k < 32; ++k) p[k] = ei_r[k] * g_ci;
          const float db = transpose_sum<32>(p, lane);
          const float a = lane_softmax(su, (mu_bits >> lane) & 1u);
          const float bw = lane_softmax(si, (mi_bits >> lane) & 1u);
          rows[lane] = make_float4(a, a * (da - warp_sum(a * da)), bw,
                                   bw * (db - warp_sum(bw * db)));
        }
        __syncwarp();

        // user rows: dEu_j += a_j dcu + s dsu_j v; dv = s sum_j dsu_j Eu_j;
        // item rows: dw += s dsi_k Ei_k; ei_r[k] becomes b_k dci + s dsi_k w
        float dv = 0.f;
#pragma unroll
        for (int j = 0; j < MAXK; ++j) {
          const float4 r = rows[j];
          dEu_r[j] += r.x * g_cu + scale * r.y * v;
          dv += r.y * eu_r[j];
          dw += scale * r.w * ei_r[j];
          ei_r[j] = r.z * g_ci + scale * r.w * w;
        }
        dv *= scale;
        // through v = Es @ Wr^T: dEs = dv @ Wr, dWr[e][k] += dv_e Es_k
        stage(vec, lane, dv);
        float des = row_dot(rowT, vec);
        outer_add(acc, vec, es);
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
            float* x = dei_acc + bc * d + lane;
            *x = (t == 0 ? 0.f : *x) + dv;
          }
        }
      }

      // through w = Em @ Wr: dEm = dw @ Wr^T, dWr[k][e] += Em_k dw_e
      deu_acc += dw;
      stage(vec, lane, dw);
      float dem = row_dot(row, vec);
      outer_add(acc, em_s, dw);
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

  // The block's partial of dWr: its warps' shares added in a fixed order,
  // warp 0 first, in sWrT, which no warp reads any more.
  const int dd = d * d;
  __syncthreads();
  for (int w2 = 0; w2 < kBwdWarpsPerBlock; ++w2) {
    if (warp == w2 && act) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (r < d) {
          float* x = sWrT + r * d + lane;
          *x = (w2 == 0 ? 0.f : *x) + acc[r];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    dWr_part[(long long)blockIdx.x * dd + i] = sWrT[i];
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

template <typename T, int MAXK, bool kMean, int kD>
void bwd_launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
                const float* Wr, const void* eu, const void* ei,
                const void* dcu, const void* dci, void* dEu, void* dEi,
                void* deu, void* dei, float* dei_acc, float* dWr_part,
                float* dWr, int B, int C, int Tn, int n, int m, int d,
                int target_aware, cudaStream_t stream) {
  const int blocks = bwd_num_partials(B);
  const float scale = 1.0f / sqrtf((float)d);
  coattn_bwd_kernel<T, MAXK, kMean, kD>
      <<<blocks, kBwdWarpsPerBlock * 32, 0, stream>>>(
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
  // holds max(n, m) keeps registers low. The benchmark's width, d = 32,
  // has instances of its own up to 16 rows.
  const int k = n > m ? n : m;
#define COATTN_BWD_LAUNCH(T, K, D)                                           \
  bwd_launch<T, K, kMean, D>(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu, dEi, \
                             deu, dei, dei_acc, dWr_part, dWr, B, C, Tn, n,  \
                             m, d, target_aware, s)
#define COATTN_BWD_DISPATCH(T)                                               \
  if (k <= 10) {                   /* the benchmark's fan-out */            \
    if (d == 32) COATTN_BWD_LAUNCH(T, 10, 32);                               \
    else COATTN_BWD_LAUNCH(T, 10, 0);                                        \
  } else if (k <= 16) {                                                      \
    if (d == 32) COATTN_BWD_LAUNCH(T, 16, 32);                               \
    else COATTN_BWD_LAUNCH(T, 16, 0);                                        \
  } else {                                                                   \
    COATTN_BWD_LAUNCH(T, 32, 0);                                             \
  }
  if (dtype == 0) {
    COATTN_BWD_DISPATCH(float)
  } else {
    COATTN_BWD_DISPATCH(__nv_bfloat16)
  }
#undef COATTN_BWD_DISPATCH
#undef COATTN_BWD_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace
