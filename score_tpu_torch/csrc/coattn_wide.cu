// Co-attention forward (sum, mean and max pools) and backward (sum and
// mean pools) in the candidates form, for widths past the tuned kernels'
// 32 lanes: any d <= 128 and n, m <= 64 neighbour rows a side.
//
// Stands in, at these widths, for the four TPU kernels the tuned CUDA
// kernels replace at d, n, m <= 32:
//   score_tpu/kernels/coattn_cand.py:_cand_fwd  (coattn_cand.cu)
//   score_tpu/kernels/coattn_cand.py:_cand_bwd  (coattn_cand_bwd.cu)
//   score_tpu/kernels/coattn.py:_coattn_fwd_pallas  (coattn_pair.cu)
//   score_tpu/kernels/coattn.py:_coattn_bwd_pallas  (coattn_pair_bwd.cu)
// The Python wrappers choose between the two kernel pairs by shape.
//
// Math, per unit (b, c, t), s = 1/sqrt(d), as coattn_cand.cuh (forward)
// and coattn_bwd.cuh (backward) give it:
//   sum/mean: Em = sum_j mu_j Eu_j, Es = sum_k mi_k Ei_ck (each divided by
//             max(count, 1) for the mean); w = Em Wr (+ eu_b),
//             v = Es Wr^T (+ ei_bc); su_j = s Eu_j . v, si_k = s Ei_ck . w
//   max:      M_jk = s (Eu_j Wr) . Ei_ck on valid (j, k) pairs; su_j =
//             max_k M_jk, si_k = max_j M_jk (0 where the other side has no
//             valid row); target-aware: + s Eu_j . ei_bc, + s Ei_ck . eu_b
//   a, b = masked softmaxes (f32, -1e9 fill; no valid row gives zeros)
//   cu = sum_j a_j Eu_j, ci = sum_k b_k Ei_ck
// and the backward's dEu (summed over c), dEi, deu and dei (summed over
// t) and dWr = sum [dv (x) Es + Em (x) dw] (coattn_bwd.cuh's note).
//
// Bound on the H100: bytes for sum and mean (the valid rows read once,
// the outputs written once; under 10 operations a byte); for the max pool
// operations, 2*n*m*d f32 operations a unit for the relation matrix at
// the card's 67 TFLOP/s on the CUDA cores, once n*m*d outgrows the bytes.
//
// This is the simple first form, right before fast:
//   * one warp owns a work item: for the forward a (b, t) and a run of its
//     candidates, for the backward an example b over all t and c, so the
//     sums over c and t need no atomics; a lane holds components lane,
//     lane + 32, ... of every d-vector (at most 4), and rows j,
//     j + 32 of every per-row value (n, m <= 64);
//   * the rows of a (b, t) and of a unit are staged in f32 in the warp's
//     shared memory (masked rows as zeros, never read), with an odd row
//     stride so that lanes reading one column of 32 rows hit 32 banks;
//     Wr is staged once a block and read as rows or columns;
//   * dots over d are lane FMAs, one row a lane; the softmaxes are warp
//     reductions; the max pool forms EuW = Eu Wr once a work item and its
//     relation matrix in a per-warp shared buffer, a (j, k) pair a lane;
//   * dWr: the backward writes each unit's (dv, Es) and each (b, t)'s
//     (Em, dw) as rows of two f32 scratch matrices X, Y; a second kernel
//     forms X^T Y in per-block partials over fixed row ranges and a third
//     adds the partials in a fixed order: the same from run to run;
//   * 16-byte row loads where the rows are a multiple of 16 bytes and the
//     inputs 16-byte aligned; scalar loads otherwise (odd d, offset views).

#include "coattn_common.cuh"

namespace {

enum WidePool { kWSum = 0, kWMean = 1, kWMax = 2 };

constexpr int kWideMaxD = 128;
constexpr int kWideMaxRows = 64;
constexpr int kWideMaxQ = kWideMaxD / 32;   // components a lane
constexpr int kWideMaxWarps = 4;
constexpr int kSmemLimit = 232448;          // bytes a block may use, sm_90
constexpr int kFwdItemsWanted = 8192;       // work items the forward aims at
constexpr int kDwrTile = 4;                 // dWr entries a thread, per axis
constexpr int kDwrRows = 32;                // X, Y rows staged at a time
constexpr int kDwrThreads = 256;

// Odd row stride of the [rows][d] f32 tiles in shared memory.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

// Floats of shared memory a forward warp uses.
__host__ __device__ inline int fwd_warp_floats(int n, int m, int d,
                                               bool max_pool) {
  const int ld = row_stride(d);
  return (n + m) * ld + (max_pool ? n * ld + n * m : 0) + 3 * d +
         2 * kWideMaxRows;
}

// Floats of shared memory a backward warp uses.
__host__ __device__ inline int bwd_warp_floats(int n, int m, int d) {
  return (2 * n + m) * row_stride(d) + 7 * d + 4 * kWideMaxRows;
}

// dst[j * ld + e] = src[j * d + e] in f32 for the valid rows j < rows,
// zeros for the masked ones, which are not read. kVec: 16-byte loads
// (d * sizeof(T) % 16 == 0 and src 16-byte aligned).
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                           const T* __restrict__ src,
                                           const uint8_t* __restrict__ mask,
                                           int rows, int d, int lane) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const int vpr = d / kPer;
    for (int i = lane; i < rows * vpr; i += 32) {
      const int j = i / vpr;
      const int q = i - j * vpr;
      float* out = dst + j * ld + q * kPer;
      if (mask[j]) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(src + (long long)j * d) + q);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < kPer; ++k) out[k] = to_f32(x[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) out[k] = 0.f;
      }
    }
  } else {
    for (int i = lane; i < rows * d; i += 32) {
      const int j = i / d;
      const int e = i - j * d;
      dst[j * ld + e] = mask[j] ? to_f32(src[(long long)j * d + e]) : 0.f;
    }
  }
}

// Valid rows of a mask of `rows` <= 64 bytes.
__device__ __forceinline__ int count_valid(const uint8_t* __restrict__ mask,
                                           int rows, int lane) {
  int c = __popc(__ballot_sync(kFull, lane < rows && mask[lane]));
  if (rows > 32) {
    c += __popc(__ballot_sync(kFull, lane + 32 < rows && mask[lane + 32]));
  }
  return c;
}

// x . y over d components, both in shared memory.
__device__ __forceinline__ float sdot(const float* __restrict__ x,
                                      const float* __restrict__ y, int d) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int e = 0;
  for (; e + 4 <= d; e += 4) {
    s0 += x[e] * y[e];
    s1 += x[e + 1] * y[e + 1];
    s2 += x[e + 2] * y[e + 2];
    s3 += x[e + 3] * y[e + 3];
  }
  for (; e < d; ++e) s0 += x[e] * y[e];
  return (s0 + s1) + (s2 + s3);
}

// Masked softmax over up to 64 rows, lane l holding rows l and l + 32:
// invalid rows weigh 0, and no valid row gives all zeros.
__device__ __forceinline__ void softmax2(float* s, const bool* valid) {
  const float mx = warp_max(fmaxf(valid[0] ? s[0] : kNeg,
                                  valid[1] ? s[1] : kNeg));
  const float e0 = valid[0] ? expf(s[0] - mx) : 0.f;
  const float e1 = valid[1] ? expf(s[1] - mx) : 0.f;
  const float den = fmaxf(warp_sum(e0 + e1), 1e-20f);
  s[0] = e0 / den;
  s[1] = e1 / den;
}

// Wr [d, d] into shared memory at row stride ld, by the whole block.
__device__ __forceinline__ void stage_wr(float* __restrict__ sWr,
                                         const float* __restrict__ Wr, int d,
                                         int ld) {
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const int k = i / d;
    sWr[k * ld + (i - k * d)] = Wr[i];
  }
  __syncthreads();
}

template <typename T, int kPool, bool kVec>
__global__ void __launch_bounds__(kWideMaxWarps * 32)
wide_fwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                const uint8_t* __restrict__ mu,
                const uint8_t* __restrict__ mi, const float* __restrict__ Wr,
                const T* __restrict__ eu, const T* __restrict__ ei,
                T* __restrict__ cu, T* __restrict__ ci, int C, int Tn, int n,
                int m, int d, int target_aware, float scale, int chunk,
                int chunks, long long items) {
  constexpr bool kMaxPool = kPool == kWMax;
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(d);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sWr = smem;                                  // Wr[k][e] at k*ld+e
  float* sEu = sWr + d * ld + warp * fwd_warp_floats(n, m, d, kMaxPool);
  float* sEi = sEu + n * ld;
  float* sEuW = sEi + m * ld;                         // max pool only
  float* sM = sEuW + (kMaxPool ? n * ld : 0);         // [n][m], max only
  float* sW = sM + (kMaxPool ? n * m : 0);    // w (sum, mean); eu (max)
  float* sV = sW + d;                         // v (sum, mean); ei (max)
  float* sVec = sV + d;                       // Em, then Es
  float* sA = sVec + d;
  float* sB = sA + kWideMaxRows;
  stage_wr(sWr, Wr, d, ld);

  for (long long item = (long long)blockIdx.x * warps + warp; item < items;
       item += (long long)gridDim.x * warps) {
    const long long bt = item / chunks;
    const int c0 = (int)(item - bt * chunks) * chunk;
    const int c1 = min(C, c0 + chunk);
    const long long b = bt / Tn;
    const int t = (int)(bt - b * Tn);
    const uint8_t* mu_bt = mu + bt * n;
    __syncwarp();   // the last item's reads of the warp's buffers are done
    stage_rows<T, kVec>(sEu, ld, Eu + bt * n * d, mu_bt, n, d, lane);
    const int cnt_u = count_valid(mu_bt, n, lane);
    __syncwarp();
    if constexpr (!kMaxPool) {
      const float inv_u =
          kPool == kWMean ? 1.f / fmaxf((float)cnt_u, 1.f) : 1.f;
      for (int e = lane; e < d; e += 32) {
        float s = 0.f;
        for (int j = 0; j < n; ++j) s += sEu[j * ld + e];
        sVec[e] = s * inv_u;
      }
      __syncwarp();
      for (int e = lane; e < d; e += 32) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s += sVec[k] * sWr[k * ld + e];
        sW[e] = target_aware ? s + to_f32(eu[b * d + e]) : s;
      }
    } else {
      for (int e = lane; e < d; e += 32) {
        for (int j = 0; j < n; ++j) {
          float s = 0.f;
          for (int k = 0; k < d; ++k) s += sEu[j * ld + k] * sWr[k * ld + e];
          sEuW[j * ld + e] = s;
        }
        sW[e] = target_aware ? to_f32(eu[b * d + e]) : 0.f;
      }
    }
    bool vu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = lane + 32 * r;
      vu[r] = j < n && mu_bt[j];
    }

    for (int c = c0; c < c1; ++c) {
      const long long bc = b * C + c;
      const long long bct = bc * Tn + t;
      const uint8_t* mi_u = mi + bct * m;
      __syncwarp();   // the last unit's reads of sEi, sV, sVec are done
      stage_rows<T, kVec>(sEi, ld, Ei + bct * m * d, mi_u, m, d, lane);
      const int cnt_i = count_valid(mi_u, m, lane);
      bool vi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = lane + 32 * r;
        vi[r] = k < m && mi_u[k];
      }
      __syncwarp();
      float su[2] = {0.f, 0.f}, si[2] = {0.f, 0.f};
      if constexpr (!kMaxPool) {
        const float inv_i =
            kPool == kWMean ? 1.f / fmaxf((float)cnt_i, 1.f) : 1.f;
        for (int e = lane; e < d; e += 32) {
          float s = 0.f;
          for (int k = 0; k < m; ++k) s += sEi[k * ld + e];
          sVec[e] = s * inv_i;
        }
        __syncwarp();
        // v_e = sum_k Wr[e][k] Es_k (+ ei_e)
        for (int e = lane; e < d; e += 32) {
          const float s = sdot(sWr + e * ld, sVec, d);
          sV[e] = target_aware ? s + to_f32(ei[bc * d + e]) : s;
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = lane + 32 * r;
          if (j < n) su[r] = sdot(sEu + j * ld, sV, d) * scale;
          if (j < m) si[r] = sdot(sEi + j * ld, sW, d) * scale;
        }
      } else {
        // the relation matrix on the valid pairs, kNeg elsewhere
        for (int p = lane; p < n * m; p += 32) {
          const int j = p / m;
          const int k = p - j * m;
          sM[p] = (mu_bt[j] && mi_u[k])
                      ? sdot(sEuW + j * ld, sEi + k * ld, d) * scale
                      : kNeg;
        }
        for (int e = lane; e < d; e += 32) {
          sV[e] = target_aware ? to_f32(ei[bc * d + e]) : 0.f;
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = lane + 32 * r;
          if (j < n) {
            float mx = kNeg;
            for (int k = 0; k < m; ++k) mx = fmaxf(mx, sM[j * m + k]);
            su[r] = cnt_i > 0 ? mx : 0.f;
            if (target_aware) su[r] += sdot(sEu + j * ld, sV, d) * scale;
          }
          if (j < m) {
            float mx = kNeg;
            for (int i = 0; i < n; ++i) mx = fmaxf(mx, sM[i * m + j]);
            si[r] = cnt_u > 0 ? mx : 0.f;
            if (target_aware) si[r] += sdot(sEi + j * ld, sW, d) * scale;
          }
        }
      }
      softmax2(su, vu);
      softmax2(si, vi);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lane + 32 * r;
        if (j < n) sA[j] = su[r];
        if (j < m) sB[j] = si[r];
      }
      __syncwarp();
      for (int e = lane; e < d; e += 32) {
        float x = 0.f, y = 0.f;
        for (int j = 0; j < n; ++j) x += sA[j] * sEu[j * ld + e];
        for (int k = 0; k < m; ++k) y += sB[k] * sEi[k * ld + e];
        cu[bct * d + e] = from_f32<T>(x);
        ci[bct * d + e] = from_f32<T>(y);
      }
    }
  }
}

// One warp an example b, over all t and c. X, Y: f32 [B*C*T + B*T, d]
// scratch rows whose product X^T Y is dWr: (dv, Es) of unit (b, c, t) at
// row (b*C + c)*T + t, (Em, dw) of (b, t) at row B*C*T + b*T + t.
template <typename T, bool kMean, bool kVec>
__global__ void __launch_bounds__(kWideMaxWarps * 32)
wide_bwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                const uint8_t* __restrict__ mu,
                const uint8_t* __restrict__ mi, const float* __restrict__ Wr,
                const T* __restrict__ eu, const T* __restrict__ ei,
                const T* __restrict__ dcu, const T* __restrict__ dci,
                T* __restrict__ dEu, T* __restrict__ dEi,
                T* __restrict__ deu, T* __restrict__ dei,
                float* __restrict__ dei_acc, float* __restrict__ X,
                float* __restrict__ Y, int B, int C, int Tn, int n, int m,
                int d, int target_aware, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(d);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sWr = smem;
  float* sEu = sWr + d * ld + warp * bwd_warp_floats(n, m, d);
  float* sdEu = sEu + n * ld;      // dEu of the (b, t), summed over c
  float* sEi = sdEu + n * ld;
  float* sEm = sEi + m * ld;
  float* sW = sEm + d;
  float* sEs = sW + d;
  float* sV = sEs + d;
  float* sGu = sV + d;             // dcu of the unit
  float* sGi = sGu + d;            // dci of the unit
  float* sDv = sGi + d;            // dv of the unit, then dw of the (b, t)
  float* sA = sDv + d;
  float* sDsu = sA + kWideMaxRows;
  float* sB = sDsu + kWideMaxRows;
  float* sDsi = sB + kWideMaxRows;
  stage_wr(sWr, Wr, d, ld);
  const long long units = (long long)B * C * Tn;

  for (long long b = (long long)blockIdx.x * warps + warp; b < B;
       b += (long long)gridDim.x * warps) {
    float deu_acc[kWideMaxQ];
#pragma unroll
    for (int q = 0; q < kWideMaxQ; ++q) deu_acc[q] = 0.f;
    for (int t = 0; t < Tn; ++t) {
      const long long bt = b * Tn + t;
      const uint8_t* mu_bt = mu + bt * n;
      __syncwarp();
      stage_rows<T, kVec>(sEu, ld, Eu + bt * n * d, mu_bt, n, d, lane);
      for (int i = lane; i < n * ld; i += 32) sdEu[i] = 0.f;
      const float inv_u =
          kMean ? 1.f / fmaxf((float)count_valid(mu_bt, n, lane), 1.f) : 1.f;
      bool vu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lane + 32 * r;
        vu[r] = j < n && mu_bt[j];
      }
      __syncwarp();
      for (int e = lane; e < d; e += 32) {
        float s = 0.f;
        for (int j = 0; j < n; ++j) s += sEu[j * ld + e];
        sEm[e] = s * inv_u;
      }
      __syncwarp();
      for (int e = lane; e < d; e += 32) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s += sEm[k] * sWr[k * ld + e];
        sW[e] = target_aware ? s + to_f32(eu[b * d + e]) : s;
      }
      float dw[kWideMaxQ];
#pragma unroll
      for (int q = 0; q < kWideMaxQ; ++q) dw[q] = 0.f;

      for (int c = 0; c < C; ++c) {
        const long long bc = b * C + c;
        const long long bct = bc * Tn + t;
        const uint8_t* mi_u = mi + bct * m;
        __syncwarp();
        stage_rows<T, kVec>(sEi, ld, Ei + bct * m * d, mi_u, m, d, lane);
        const float inv_i =
            kMean ? 1.f / fmaxf((float)count_valid(mi_u, m, lane), 1.f)
                  : 1.f;
        bool vi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = lane + 32 * r;
          vi[r] = k < m && mi_u[k];
        }
        for (int e = lane; e < d; e += 32) {
          sGu[e] = to_f32(dcu[bct * d + e]);
          sGi[e] = to_f32(dci[bct * d + e]);
        }
        __syncwarp();
        for (int e = lane; e < d; e += 32) {
          float s = 0.f;
          for (int k = 0; k < m; ++k) s += sEi[k * ld + e];
          sEs[e] = s * inv_i;
        }
        __syncwarp();
        for (int e = lane; e < d; e += 32) {
          const float s = sdot(sWr + e * ld, sEs, d);
          sV[e] = target_aware ? s + to_f32(ei[bc * d + e]) : s;
        }
        __syncwarp();
        // scores and the weighted sums' gradients, a row a lane
        float a[2] = {0.f, 0.f}, da[2] = {0.f, 0.f};
        float bw[2] = {0.f, 0.f}, db[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = lane + 32 * r;
          if (j < n) {
            a[r] = sdot(sEu + j * ld, sV, d) * scale;
            da[r] = sdot(sEu + j * ld, sGu, d);
          }
          if (j < m) {
            bw[r] = sdot(sEi + j * ld, sW, d) * scale;
            db[r] = sdot(sEi + j * ld, sGi, d);
          }
        }
        softmax2(a, vu);
        softmax2(bw, vi);
        const float ada = warp_sum(a[0] * da[0] + a[1] * da[1]);
        const float bdb = warp_sum(bw[0] * db[0] + bw[1] * db[1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = lane + 32 * r;
          if (j < n) {
            sA[j] = a[r];
            sDsu[j] = a[r] * (da[r] - ada);
          }
          if (j < m) {
            sB[j] = bw[r];
            sDsi[j] = bw[r] * (db[r] - bdb);
          }
        }
        __syncwarp();
        // dEu_j += a_j dcu + s dsu_j v; dv = s sum_j dsu_j Eu_j;
        // dw += s sum_k dsi_k Ei_k
#pragma unroll
        for (int q = 0; q < kWideMaxQ; ++q) {
          const int e = lane + 32 * q;
          if (e < d) {
            const float gu = sGu[e];
            const float v = sV[e];
            float dv = 0.f;
            for (int j = 0; j < n; ++j) {
              const float ds = sDsu[j];
              sdEu[j * ld + e] += sA[j] * gu + scale * ds * v;
              dv += ds * sEu[j * ld + e];
            }
            dv *= scale;
            float dwc = 0.f;
            for (int k = 0; k < m; ++k) dwc += sDsi[k] * sEi[k * ld + e];
            dw[q] += scale * dwc;
            sDv[e] = dv;
            X[bct * d + e] = dv;
            Y[bct * d + e] = sEs[e];
            if (target_aware) {
              float* x = dei_acc + bc * d + e;
              *x = (t == 0 ? 0.f : *x) + dv;
            }
          }
        }
        __syncwarp();
        // through v = Es Wr^T: dEs_k = sum_e dv_e Wr[e][k];
        // dEi_k = b_k dci + s dsi_k w + mi_k dEs [/ cnt_i]
        for (int e = lane; e < d; e += 32) {
          float des = 0.f;
          for (int f = 0; f < d; ++f) des += sDv[f] * sWr[f * ld + e];
          des *= inv_i;
          const float gi = sGi[e];
          const float w = sW[e];
          T* out = dEi + bct * m * d + e;
          for (int k = 0; k < m; ++k) {
            out[k * d] = from_f32<T>(
                mi_u[k] ? sB[k] * gi + scale * sDsi[k] * w + des : 0.f);
          }
        }
      }

      // through w = Em Wr: dEm_k = sum_e dw_e Wr[k][e];
      // dEu_j = (sum over c) + mu_j dEm [/ cnt_u]
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kWideMaxQ; ++q) {
        const int e = lane + 32 * q;
        if (e < d) sDv[e] = dw[q];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kWideMaxQ; ++q) {
        const int k = lane + 32 * q;
        if (k < d) {
          const float dem = sdot(sWr + k * ld, sDv, d) * inv_u;
          T* out = dEu + bt * n * d + k;
          for (int j = 0; j < n; ++j) {
            out[j * d] = from_f32<T>(mu_bt[j] ? sdEu[j * ld + k] + dem : 0.f);
          }
          X[(units + bt) * d + k] = sEm[k];
          Y[(units + bt) * d + k] = dw[q];
          deu_acc[q] += dw[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kWideMaxQ; ++q) {
      const int e = lane + 32 * q;
      if (e < d) {
        deu[b * d + e] = from_f32<T>(target_aware ? deu_acc[q] : 0.f);
        for (int c = 0; c < C; ++c) {
          const long long i = (b * C + c) * d + e;
          dei[i] = from_f32<T>(target_aware ? dei_acc[i] : 0.f);
        }
      }
    }
  }
}

// part[g] = sum over rows z of block g's range of X[z] (x) Y[z] ([d, d]):
// a thread owns kDwrTile x kDwrTile entries a slot; the rows go through
// shared memory kDwrRows at a time, zero-padded to a multiple of 4 wide.
__global__ void __launch_bounds__(kDwrThreads)
wide_dwr_partial_kernel(const float* __restrict__ X,
                        const float* __restrict__ Y, long long Z, int d,
                        long long rows_per, float* __restrict__ part) {
  constexpr int kSlots =
      (kWideMaxD / kDwrTile) * (kWideMaxD / kDwrTile) / kDwrThreads;
  __shared__ __align__(16) float sX[kDwrRows][kWideMaxD];
  __shared__ __align__(16) float sY[kDwrRows][kWideMaxD];
  const int tiles = (d + kDwrTile - 1) / kDwrTile;   // a side
  const int dp = tiles * kDwrTile;
  float acc[kSlots][kDwrTile][kDwrTile];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int i = 0; i < kDwrTile; ++i)
#pragma unroll
      for (int j = 0; j < kDwrTile; ++j) acc[s][i][j] = 0.f;
  const long long z0 = blockIdx.x * rows_per;
  const long long z1 = min(Z, z0 + rows_per);
  for (long long zc = z0; zc < z1; zc += kDwrRows) {
    const int rows = (int)min((long long)kDwrRows, z1 - zc);
    __syncthreads();
    for (int i = threadIdx.x; i < kDwrRows * dp; i += blockDim.x) {
      const int z = i / dp;
      const int e = i - z * dp;
      const bool in = z < rows && e < d;
      sX[z][e] = in ? X[(zc + z) * d + e] : 0.f;
      sY[z][e] = in ? Y[(zc + z) * d + e] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int tile = threadIdx.x + s * kDwrThreads;
      if (tile < tiles * tiles) {
        const int r0 = (tile / tiles) * kDwrTile;
        const int c0 = (tile % tiles) * kDwrTile;
        for (int z = 0; z < rows; ++z) {
          const float4 x = *reinterpret_cast<const float4*>(&sX[z][r0]);
          const float4 y = *reinterpret_cast<const float4*>(&sY[z][c0]);
          const float xs[4] = {x.x, x.y, x.z, x.w};
          const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int i = 0; i < kDwrTile; ++i)
#pragma unroll
            for (int j = 0; j < kDwrTile; ++j) acc[s][i][j] += xs[i] * ys[j];
        }
      }
    }
  }
  float* out = part + (long long)blockIdx.x * d * d;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int tile = threadIdx.x + s * kDwrThreads;
    if (tile < tiles * tiles) {
      const int r0 = (tile / tiles) * kDwrTile;
      const int c0 = (tile % tiles) * kDwrTile;
#pragma unroll
      for (int i = 0; i < kDwrTile; ++i)
#pragma unroll
        for (int j = 0; j < kDwrTile; ++j) {
          if (r0 + i < d && c0 + j < d) out[(r0 + i) * d + c0 + j] = acc[s][i][j];
        }
    }
  }
}

// out[e] = sum_g part[g][e], in the order g = 0, 1, ...
__global__ void wide_sum_partials_kernel(const float* __restrict__ part,
                                         int G, int dd,
                                         float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < dd) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += part[(long long)g * dd + e];
    out[e] = s;
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Warps a block, at most 4, that fit next to Wr in shared memory with
// `per_warp` floats each; the launch's shared-memory bytes in *smem.
int fit_warps(int d, int per_warp, long long work, int* smem) {
  const int wr = d * row_stride(d) * 4;
  int w = (kSmemLimit - wr) / (per_warp * 4);
  if (w > kWideMaxWarps) w = kWideMaxWarps;
  if (w > work) w = (int)work;
  *smem = wr + w * per_warp * 4;
  return w;
}

// Grid of a kernel whose blocks loop over their work: the blocks that are
// resident at once, or fewer where the work is smaller.
template <typename Kernel>
int grid_for(Kernel kernel, int threads, int smem, long long blocks_wanted) {
  int per_sm = 1;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long cap = (long long)num_sms() * (per_sm > 0 ? per_sm : 1);
  return (int)(blocks_wanted < cap ? blocks_wanted : cap);
}

template <typename T, int kPool, bool kVec>
int fwd_launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
               const float* Wr, const void* eu, const void* ei, void* cu,
               void* ci, int B, int C, int Tn, int n, int m, int d,
               int target_aware, cudaStream_t stream) {
  // a warp's work item: a (b, t) and a run of `chunk` candidates, split so
  // that about kFwdItemsWanted items run where B * T is small
  const long long bt = (long long)B * Tn;
  long long chunks = (kFwdItemsWanted + bt - 1) / bt;
  if (chunks > C) chunks = C;
  const int chunk = (int)((C + chunks - 1) / chunks);
  chunks = (C + chunk - 1) / chunk;
  const long long items = bt * chunks;
  int smem = 0;
  const int warps =
      fit_warps(d, fwd_warp_floats(n, m, d, kPool == kWMax), items, &smem);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  auto kernel = wide_fwd_kernel<T, kPool, kVec>;
  const int blocks =
      grid_for(kernel, warps * 32, smem, (items + warps - 1) / warps);
  kernel<<<blocks, warps * 32, smem, stream>>>(
      (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi, Wr,
      (const T*)eu, (const T*)ei, (T*)cu, (T*)ci, C, Tn, n, m, d,
      target_aware, 1.0f / sqrtf((float)d), chunk, (int)chunks, items);
  return (int)cudaGetLastError();
}

template <typename T, int kPool>
int fwd_dispatch(bool vec, const void* Eu, const void* Ei, const void* mu,
                 const void* mi, const float* Wr, const void* eu,
                 const void* ei, void* cu, void* ci, int B, int C, int Tn,
                 int n, int m, int d, int target_aware, cudaStream_t s) {
  return vec ? fwd_launch<T, kPool, true>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci,
                                          B, C, Tn, n, m, d, target_aware, s)
             : fwd_launch<T, kPool, false>(Eu, Ei, mu, mi, Wr, eu, ei, cu,
                                           ci, B, C, Tn, n, m, d,
                                           target_aware, s);
}

template <typename T>
int fwd_pool(int pool, bool vec, const void* Eu, const void* Ei,
             const void* mu, const void* mi, const float* Wr, const void* eu,
             const void* ei, void* cu, void* ci, int B, int C, int Tn, int n,
             int m, int d, int target_aware, cudaStream_t s) {
  if (pool == kWSum) {
    return fwd_dispatch<T, kWSum>(vec, Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B,
                                  C, Tn, n, m, d, target_aware, s);
  }
  if (pool == kWMean) {
    return fwd_dispatch<T, kWMean>(vec, Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B,
                                   C, Tn, n, m, d, target_aware, s);
  }
  return fwd_dispatch<T, kWMax>(vec, Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C,
                                Tn, n, m, d, target_aware, s);
}

template <typename T, bool kMean, bool kVec>
int bwd_launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
               const float* Wr, const void* eu, const void* ei,
               const void* dcu, const void* dci, void* dEu, void* dEi,
               void* deu, void* dei, float* dei_acc, float* xy,
               float* dWr_part, int parts, float* dWr, int B, int C, int Tn,
               int n, int m, int d, int target_aware, cudaStream_t stream) {
  int smem = 0;
  const int warps = fit_warps(d, bwd_warp_floats(n, m, d), B, &smem);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  auto kernel = wide_bwd_kernel<T, kMean, kVec>;
  const int blocks = grid_for(kernel, warps * 32, smem, (B + warps - 1) / warps);
  const long long Z = (long long)B * Tn * (C + 1);   // rows of X and Y
  float* X = xy;
  float* Y = xy + Z * d;
  kernel<<<blocks, warps * 32, smem, stream>>>(
      (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi, Wr,
      (const T*)eu, (const T*)ei, (const T*)dcu, (const T*)dci, (T*)dEu,
      (T*)dEi, (T*)deu, (T*)dei, dei_acc, X, Y, B, C, Tn, n, m, d,
      target_aware, 1.0f / sqrtf((float)d));
  const long long rows_per = (Z + parts - 1) / parts;
  wide_dwr_partial_kernel<<<parts, kDwrThreads, 0, stream>>>(X, Y, Z, d,
                                                             rows_per,
                                                             dWr_part);
  const int dd = d * d;
  wide_sum_partials_kernel<<<(dd + 255) / 256, 256, 0, stream>>>(
      dWr_part, parts, dd, dWr);
  return (int)cudaGetLastError();
}

template <typename T, bool kMean>
int bwd_dispatch(bool vec, const void* Eu, const void* Ei, const void* mu,
                 const void* mi, const float* Wr, const void* eu,
                 const void* ei, const void* dcu, const void* dci, void* dEu,
                 void* dEi, void* deu, void* dei, float* dei_acc, float* xy,
                 float* dWr_part, int parts, float* dWr, int B, int C, int Tn,
                 int n, int m, int d, int target_aware, cudaStream_t s) {
  return vec ? bwd_launch<T, kMean, true>(Eu, Ei, mu, mi, Wr, eu, ei, dcu,
                                          dci, dEu, dEi, deu, dei, dei_acc,
                                          xy, dWr_part, parts, dWr, B, C, Tn,
                                          n, m, d, target_aware, s)
             : bwd_launch<T, kMean, false>(Eu, Ei, mu, mi, Wr, eu, ei, dcu,
                                           dci, dEu, dEi, deu, dei, dei_acc,
                                           xy, dWr_part, parts, dWr, B, C,
                                           Tn, n, m, d, target_aware, s);
}

bool wide_shape_ok(int n, int m, int d) {
  return d >= 1 && d <= kWideMaxD && n >= 1 && n <= kWideMaxRows && m >= 1 &&
         m <= kWideMaxRows;
}

}  // namespace

// pool: 0 = sum, 1 = mean, 2 = max. dtype: 0 = float32, 1 = bfloat16 (Eu,
// Ei, eu, ei, cu and ci share it); Wr is f32; masks are bool bytes.
extern "C" int wide_fwd(const void* Eu, const void* Ei, const void* mu,
                        const void* mi, const float* Wr, const void* eu,
                        const void* ei, void* cu, void* ci, int B, int C,
                        int Tn, int n, int m, int d, int target_aware,
                        int pool, int dtype, void* stream) {
  if (!wide_shape_ok(n, m, d) || dtype < 0 || dtype > 1 || pool < 0 ||
      pool > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * C * Tn == 0) return 0;
  const int es = dtype == 0 ? 4 : 2;
  const bool vec = (d * es) % 16 == 0 && aligned16(Eu) && aligned16(Ei);
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? fwd_pool<float>(pool, vec, Eu, Ei, mu, mi, Wr, eu, ei, cu, ci,
                               B, C, Tn, n, m, d, target_aware, s)
             : fwd_pool<__nv_bfloat16>(pool, vec, Eu, Ei, mu, mi, Wr, eu, ei,
                                       cu, ci, B, C, Tn, n, m, d,
                                       target_aware, s);
}

// pool: 0 = sum, 1 = mean. dtype as wide_fwd (also dcu, dci and the
// gradients dEu, dEi, deu, dei). Wr and dWr are f32. Scratch, f32:
// dei_acc [B, C, d] (unused when not target-aware), xy [2, B*T*(C+1), d],
// dWr_part [parts, d, d]. B, C and T must be >= 1.
extern "C" int wide_bwd(const void* Eu, const void* Ei, const void* mu,
                        const void* mi, const float* Wr, const void* eu,
                        const void* ei, const void* dcu, const void* dci,
                        void* dEu, void* dEi, void* deu, void* dei,
                        float* dei_acc, float* xy, float* dWr_part, int parts,
                        float* dWr, int B, int C, int Tn, int n, int m, int d,
                        int target_aware, int pool, int dtype, void* stream) {
  if (!wide_shape_ok(n, m, d) || B < 1 || C < 1 || Tn < 1 || parts < 1 ||
      dtype < 0 || dtype > 1 || pool < 0 || pool > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int es = dtype == 0 ? 4 : 2;
  const bool vec = (d * es) % 16 == 0 && aligned16(Eu) && aligned16(Ei);
  cudaStream_t s = (cudaStream_t)stream;
#define WIDE_BWD(T, MEAN)                                                    \
  bwd_dispatch<T, MEAN>(vec, Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu, dEi, \
                        deu, dei, dei_acc, xy, dWr_part, parts, dWr, B, C,   \
                        Tn, n, m, d, target_aware, s)
  if (dtype == 0) return pool == 1 ? WIDE_BWD(float, true) : WIDE_BWD(float, false);
  return pool == 1 ? WIDE_BWD(__nv_bfloat16, true)
                   : WIDE_BWD(__nv_bfloat16, false);
#undef WIDE_BWD
}

extern "C" const char* coattn_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
