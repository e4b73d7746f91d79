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
// The forward is the simple first form, right before fast:
//   * one warp owns a work item, a (b, t) and a run of its candidates; a
//     lane holds components lane, lane + 32, ... of every d-vector (at
//     most 4), and rows j, j + 32 of every per-row value (n, m <= 64);
//   * the rows of a (b, t) and of a unit are staged in f32 in the warp's
//     shared memory (masked rows as zeros, never read), with an odd row
//     stride so that lanes reading one column of 32 rows hit 32 banks;
//     Wr is staged once a block and read as rows or columns;
//   * dots over d are lane FMAs, one row a lane; the softmaxes are warp
//     reductions; the max pool forms EuW = Eu Wr once a work item and its
//     relation matrix in a per-warp shared buffer, a (j, k) pair a lane;
//   * 16-byte row loads where the rows are a multiple of 16 bytes and the
//     inputs 16-byte aligned; scalar loads otherwise (odd d, offset views).
//
// The backward is laid out for the card (its predecessor, a warp an
// example over all T x C units with dWr through 2 x B*T*(C+1) x d f32
// scratch rows and two more launches, took 1.23 ms at configs3's d=64
// training shape, 16x its 0.075 ms bound; chip_ab_coattn.py times both):
//   * a block per example at a time, persistent over its examples, a warp
//     per slot t (the block's warps take its (b, t) items in order, as
//     many at once as shared memory holds, at most 16; 8 past d = 64,
//     with up to 255 registers a thread), on one grid of
//     the resident blocks;
//   * an item's global loads go in two waves: its mask bytes and small
//     vectors, then its user rows and first two candidates' rows in
//     16-byte loads, several a lane in flight (a Q-wide load a row left
//     the warps waiting on memory for a third of the time);
//   * Wr is staged once a block; a lane holds Q = d/32 neighbouring
//     components of every vector in registers, so its rows' reads and
//     stores, in shared and device memory, are one Q-wide access each;
//   * a warp takes its slot's candidates two at a time: each Wr element it
//     reads serves both candidates' rows of the d x d products, and each
//     user row both candidates' dots; the products read Wr as rows
//     (x Wr: a lane's Q columns) or as 16-byte pieces of a lane's rows
//     (Wr x, conflict-free at row stride d + 4), with the vector broadcast;
//   * the per-row dots (scores and their gradients) go 32 at a time
//     through a transposing butterfly (coattn_common.cuh's transpose_sum)
//     instead of a lane loop over d for each row; up to 16 rows a side,
//     the four softmaxes take two half-warps each;
//   * dWr, deu and dei never leave the block until its end: each item
//     leaves its dWr rows (dv_c, Es_c for each c, then Em, dw) in shared
//     memory, and after each round of items the block adds X^T Y into a
//     [d, d] f32 accumulator (each thread its own 4 x 4 tiles; in shared
//     memory, or in the block's partial in device memory where that lets
//     more warps in) and the rows into the sums over t, in item order:
//     the same from run to run, with no atomics and no scratch rows; a
//     second launch adds the blocks' partials in block order.
// Its time at the d=64 training shape, bf16: 0.46 ms by CUDA graph on an
// H100 SXM at 700 W (6x the bound), issue- and latency-bound on shared
// memory and shuffles with 16 warps an SM; the d x d products' reads of
// Wr are half the shared-memory traffic, which tensor-core tiles across
// the block's items would take off it.

#include <initializer_list>

#include "coattn_common.cuh"

namespace {

enum WidePool { kWSum = 0, kWMean = 1, kWMax = 2 };

constexpr int kWideMaxD = 128;
constexpr int kWideMaxRows = 64;
constexpr int kWideMaxWarps = 4;
constexpr int kSmemLimit = 232448;          // bytes a block may use, sm_90
constexpr int kFwdItemsWanted = 8192;       // work items the forward aims at

// Odd row stride of the [rows][d] f32 tiles in shared memory.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

// Floats of shared memory a forward warp uses.
__host__ __device__ inline int fwd_warp_floats(int n, int m, int d,
                                               bool max_pool) {
  const int ld = row_stride(d);
  return (n + m) * ld + (max_pool ? n * ld + n * m : 0) + 3 * d +
         2 * kWideMaxRows;
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

// --- the backward -----------------------------------------------------------
//
// A block per example b at a time, persistent over the b's blockIdx.x,
// blockIdx.x + gridDim.x, ...; its warps take the (b, t) items of those b's
// in order, one each, a round of `warps` items at a time (a round may span
// two b's, or a b several rounds). A warp's item is one (b, t) and all its
// C candidates, kChunk of them at once. Lane l holds components Q l ..
// Q l + Q - 1 of every d-vector, in registers (dp = 32 Q >= d; components
// past d are zeros). After each round the block adds its items' dWr rows
// and its dei, deu rows in a fixed order (items, then rows) into its own
// accumulators in shared memory; a b's dei and deu are written with its
// last t, the block's dWr at its end as one partial, and a second kernel
// sums the partials in block order: the same from run to run.

constexpr int kChunk = 2;            // candidates a warp takes at once
// Warps a backward block holds at most: 16 (128 registers a thread); 8 at
// Q = 4 (d > 64), whose products and butterflies spill at 128 registers
// and run faster at up to 255 on 8 warps an SM.
__host__ __device__ constexpr int bwd_max_warps(int Q) {
  return Q == 4 ? 8 : 16;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats of shared memory a backward block uses besides its warps': Wr at
// row stride dp + 4, the dWr accumulator (where `acc_smem`; else it is the
// block's partial in device memory), the dei and deu sums of a b.
__host__ __device__ inline int bwd_block_floats(int dp, int C, bool acc_smem) {
  return dp * (dp + 4) + (acc_smem ? dp * dp : 0) + (C + 1) * dp;
}

// Floats of shared memory a backward warp uses (see wide_bwd_kernel).
__host__ __device__ inline int bwd_warp_floats(int n, int m, int dp, int C) {
  return (n + kChunk * m + 2 * kChunk + 2 * (C + 1)) * dp + 4 * n +
         2 * kChunk * m + round4(2 * kChunk * (n + m)) +
         (C > kChunk ? n * dp : 0);
}

template <int Q>
__device__ __forceinline__ void lds_q(float (&x)[Q], const float* p) {
  if constexpr (Q == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (Q == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int Q>
__device__ __forceinline__ void sts_q(float* p, const float (&x)[Q]) {
  if constexpr (Q == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (Q == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

template <typename T, int Q>
struct alignas(sizeof(T) * Q) Pack {
  T v[Q];
};

// Components e0 .. e0 + Q - 1 of a row of d values of T, in f32 (zeros past
// d). vec: one Q-wide access (d % Q == 0, the row's base aligned to it).
template <typename T, int Q>
__device__ __forceinline__ void ldg_q(float (&x)[Q], const T* __restrict__ row,
                                      int e0, int d, bool vec) {
  if (vec) {
    if (e0 < d) {
      const Pack<T, Q> p = *reinterpret_cast<const Pack<T, Q>*>(row + e0);
#pragma unroll
      for (int q = 0; q < Q; ++q) x[q] = to_f32(p.v[q]);
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) x[q] = 0.f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) x[q] = e0 + q < d ? to_f32(row[e0 + q]) : 0.f;
  }
}

template <typename T, int Q>
__device__ __forceinline__ void stg_q(T* __restrict__ row, const float (&x)[Q],
                                      int e0, int d, bool vec) {
  if (vec) {
    if (e0 < d) {
      Pack<T, Q> p;
#pragma unroll
      for (int q = 0; q < Q; ++q) p.v[q] = from_f32<T>(x[q]);
      *reinterpret_cast<Pack<T, Q>*>(row + e0) = p;
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (e0 + q < d) row[e0 + q] = from_f32<T>(x[q]);
    }
  }
}

template <int Q>
__device__ __forceinline__ float dot_q(const float (&x)[Q],
                                       const float (&y)[Q]) {
  float s = x[0] * y[0];
#pragma unroll
  for (int q = 1; q < Q; ++q) s = fmaf(x[q], y[q], s);
  return s;
}

// Rows 0 .. rows - 1 of d values of T (row j at src + j * d, valid where
// bit j of `bits` is set; masked rows are zeros) into dst [rows][dp] in
// f32, lane l's components Q l .. Q l + Q - 1, adding the rows into sum.
// A batch of 32 / Q rows' loads (8 bytes of f32 a lane and row at Q = 2)
// is issued before any of them is used, so a lane has a batch in flight
// where a row at a time would wait for each.
template <typename T, int Q>
__device__ __forceinline__ void stage_rows_q(float* __restrict__ dst,
                                             const T* __restrict__ src,
                                             unsigned long long bits,
                                             int rows, int d, int e0,
                                             bool vec, float (&sum)[Q]) {
  constexpr int dp = 32 * Q, kBatch = 32 / Q;
  for (int j0 = 0; j0 < rows; j0 += kBatch) {
    float x[kBatch][Q];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
#pragma unroll
      for (int q = 0; q < Q; ++q) x[r][q] = 0.f;
      if (j0 + r < rows && ((bits >> (j0 + r)) & 1)) {
        ldg_q<T, Q>(x[r], src + (long long)(j0 + r) * d, e0, d, vec);
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      if (j0 + r < rows) {
        sts_q<Q>(dst + (j0 + r) * dp + e0, x[r]);
#pragma unroll
        for (int q = 0; q < Q; ++q) sum[q] += x[r][q];
      }
    }
  }
}

// Rows of d values of T from up to three blocks (rows [0, end0) at src0,
// [end0, end1) at src1, [end1, rows) at src2, row j valid where bit j of
// its block's bits is set; masked rows are zeros) into dst [rows][dp] in
// f32, components past d left as they are (zeros). 16 bytes a load (d *
// sizeof(T) % 16 == 0, the blocks 16-byte aligned), each lane kVB loads
// in flight, so a warp stages a (b, t)'s user rows and its first two
// candidates' rows in a load or two a lane (d = 64, bf16), where a Q-wide
// load a row would take a load a row.
template <typename T, int Q>
__device__ __forceinline__ void stage_rows_v(
    float* __restrict__ dst, const T* src0, unsigned long long bits0,
    int end0, const T* src1, unsigned long long bits1, int end1,
    const T* src2, unsigned long long bits2, int rows, int d, int lane) {
  constexpr int dp = 32 * Q, per = 16 / sizeof(T), kVB = 8;
  const int vpr = d / per;
  const int total = rows * vpr;
  for (int i0 = lane; i0 < total; i0 += 32 * kVB) {
    uint4 raw[kVB];
#pragma unroll
    for (int u = 0; u < kVB; ++u) {
      const int i = i0 + 32 * u;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total) {
        const int j = i / vpr;
        const int blk = (j >= end0) + (j >= end1);
        const int jj = j - (blk == 0 ? 0 : blk == 1 ? end0 : end1);
        const unsigned long long bits =
            blk == 0 ? bits0 : blk == 1 ? bits1 : bits2;
        if ((bits >> jj) & 1) {
          const T* src = blk == 0 ? src0 : blk == 1 ? src1 : src2;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
                             src + (long long)jj * d) + (i - j * vpr));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kVB; ++u) {
      const int i = i0 + 32 * u;
      if (i < total) {
        const int j = i / vpr;
        float* out = dst + j * dp + (i - j * vpr) * per;
        const T* x = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int k = 0; k < per; k += 4) {
          *reinterpret_cast<float4*>(out + k) =
              make_float4(to_f32(x[k]), to_f32(x[k + 1]), to_f32(x[k + 2]),
                          to_f32(x[k + 3]));
        }
      }
    }
  }
}

// sum[q] = sum over the rows of src [rows][dp] of component e0 + q.
template <int Q>
__device__ __forceinline__ void sum_rows(float (&sum)[Q],
                                         const float* __restrict__ src,
                                         int rows, int e0) {
  constexpr int dp = 32 * Q;
#pragma unroll 4
  for (int j = 0; j < rows; ++j) {
    float x[Q];
    lds_q<Q>(x, src + j * dp + e0);
#pragma unroll
    for (int q = 0; q < Q; ++q) sum[q] += x[q];
  }
}

// The masked softmaxes of G groups of up to 64 rows at once (group i's
// rows lane and lane + 32 in s[i], their valid flags in ok[i]), their
// reductions interleaved; then each row's gradient factor: g[i] becomes
// scale * a (g - sum a g), s[i] the weights a. W = 16: each half-warp
// reduces on its own, a group of up to 16 rows in each (rows in s[i][0]).
template <int G, int W = 32>
__device__ __forceinline__ void softmax_groups(float (&s)[G][2],
                                               float (&g)[G][2],
                                               const bool (&ok)[G][2],
                                               float scale) {
  float mx[G], den[G], ag[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    mx[i] = fmaxf(ok[i][0] ? s[i][0] : kNeg, ok[i][1] ? s[i][1] : kNeg);
  }
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < G; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], o));
    }
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) s[i][r] = ok[i][r] ? expf(s[i][r] - mx[i]) : 0.f;
    den[i] = s[i][0] + s[i][1];
  }
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < G; ++i) den[i] += __shfl_xor_sync(kFull, den[i], o);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    den[i] = fmaxf(den[i], 1e-20f);
#pragma unroll
    for (int r = 0; r < 2; ++r) s[i][r] = s[i][r] / den[i];
    ag[i] = s[i][0] * g[i][0] + s[i][1] * g[i][1];
  }
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < G; ++i) ag[i] += __shfl_xor_sync(kFull, ag[i], o);
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) g[i][r] = scale * (s[i][r] * (g[i][r] - ag[i]));
}

// out[v] = x_v Wr for the NV vectors x_v at sX + v * dp (out[v][q] =
// sum_k x_v[k] Wr[k][e0 + q]): each Wr element read serves all NV rows.
template <int Q, int NV>
__device__ __forceinline__ void x_wr(float (&out)[NV][Q],
                                     const float* __restrict__ sX,
                                     const float* __restrict__ sWr, int kd4,
                                     int e0) {
  constexpr int dp = 32 * Q, ldw = dp + 4, kMatU = Q == 4 ? 2 : 4;
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int q = 0; q < Q; ++q) out[v][q] = 0.f;
  for (int k0 = 0; k0 < kd4; k0 += kMatU) {
#pragma unroll
    for (int u = 0; u < kMatU; ++u) {
      const int k4 = k0 + u;
      if (k4 < kd4) {
        float4 x[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          x[v] = *reinterpret_cast<const float4*>(sX + v * dp + 4 * k4);
        }
        float wr[4][Q];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          lds_q<Q>(wr[kk], sWr + (4 * k4 + kk) * ldw + e0);
        }
#pragma unroll
        for (int v = 0; v < NV; ++v) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            float s = out[v][q];
            s = fmaf(x[v].x, wr[0][q], s);
            s = fmaf(x[v].y, wr[1][q], s);
            s = fmaf(x[v].z, wr[2][q], s);
            out[v][q] = fmaf(x[v].w, wr[3][q], s);
          }
        }
      }
    }
  }
}

// out[v] = Wr x_v (out[v][q] = sum_k Wr[e0 + q][k] x_v[k]). Lane l forms
// components l, l + 32, ... from 16-byte reads of Wr's rows (row stride
// dp + 4: the 8 lanes of a read phase hit 8 distinct bank quads), then the
// components go through sT (NV rows of dp) to the lane that holds them.
template <int Q, int NV>
__device__ __forceinline__ void wr_x(float (&out)[NV][Q],
                                     const float* __restrict__ sX,
                                     float* __restrict__ sT,
                                     const float* __restrict__ sWr, int kd4,
                                     int lane, int e0) {
  constexpr int dp = 32 * Q, ldw = dp + 4, kMatU = Q == 4 ? 2 : 4;
  float acc[NV][Q];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < Q; ++i) acc[v][i] = 0.f;
  for (int k0 = 0; k0 < kd4; k0 += kMatU) {
#pragma unroll
    for (int u = 0; u < kMatU; ++u) {
      const int k4 = k0 + u;
      if (k4 < kd4) {
        float4 x[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          x[v] = *reinterpret_cast<const float4*>(sX + v * dp + 4 * k4);
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(
              sWr + (lane + 32 * i) * ldw + 4 * k4);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float s = acc[v][i];
            s = fmaf(w.x, x[v].x, s);
            s = fmaf(w.y, x[v].y, s);
            s = fmaf(w.z, x[v].z, s);
            acc[v][i] = fmaf(w.w, x[v].w, s);
          }
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < Q; ++i) sT[v * dp + lane + 32 * i] = acc[v][i];
  __syncwarp();
#pragma unroll
  for (int v = 0; v < NV; ++v) lds_q<Q>(out[v], sT + v * dp + e0);
}

// Per warp, in shared memory (f32; dp-wide rows, lane l at Q l):
//   sEu [n][dp]           the (b, t)'s user rows (masked rows zeros)
//   sEi [kChunk][m][dp]   the chunk's item rows
//   sVec [2 kChunk][dp]   vectors a product reads, and its transposes
//   sRows [C + 1][2][dp]  the item's dWr rows X, Y: (dv_c, Es_c) for each
//                         c, then (Em, dw)
//   sAU [n][4]            a_jc and s dsu_jc for c = 0, 1 of the chunk
//   sBI [kChunk][m][2]    b_ck and s dsi_ck
//   sDot                  su, da [2][kChunk][n]; then si, db [2][kChunk][m]
//   sdEu [n][dp]          (C > kChunk only) dEu's sum over the earlier
//                         chunks
template <typename T, bool kMean, int Q>
__global__ void __launch_bounds__(bwd_max_warps(Q) * 32, 1)
wide_bwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                const uint8_t* __restrict__ mu,
                const uint8_t* __restrict__ mi, const float* __restrict__ Wr,
                const T* __restrict__ eu, const T* __restrict__ ei,
                const T* __restrict__ dcu, const T* __restrict__ dci,
                T* __restrict__ dEu, T* __restrict__ dEi,
                T* __restrict__ deu, T* __restrict__ dei,
                float* __restrict__ dWr_part, int B, int C, int Tn, int n,
                int m, int d, int target_aware, int vec_io, int acc_smem,
                float scale) {
  constexpr int dp = 32 * Q, ldw = dp + 4, tside = dp / 4;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e0 = Q * lane;
  const int kd4 = (d + 3) >> 2;   // 4-wide steps over the components < d
  const bool vec = (vec_io & 1) != 0;     // Q-wide row accesses
  const bool vec16 = (vec_io & 2) != 0;   // 16-byte row staging
  float* sWr = smem;                          // Wr[k][e] at k * ldw + e
  float* part = dWr_part + (long long)blockIdx.x * dp * dp;
  // the block's dWr [dp][dp]: in shared memory where it fits, else its
  // partial in device memory (L2), each entry read and written by one thread
  float* sAcc = acc_smem ? sWr + dp * ldw : part;
  float* sDe = sWr + dp * ldw + (acc_smem ? dp * dp : 0);   // [C + 1][dp]
  float* sWarps = sDe + (C + 1) * dp;
  const int wf = bwd_warp_floats(n, m, dp, C);
  float* sEu = sWarps + warp * wf;
  float* sEi = sEu + n * dp;
  float* sVec = sEi + kChunk * m * dp;
  float* sRows = sVec + 2 * kChunk * dp;
  float* sAU = sRows + 2 * (C + 1) * dp;
  float* sBI = sAU + 4 * n;
  float* sDot = sBI + 2 * kChunk * m;
  float* sDotI = sDot + 2 * kChunk * n;
  float* sdEu = sDot + round4(2 * kChunk * (n + m));

  for (int i = threadIdx.x; i < dp * dp; i += blockDim.x) {
    const int k = i / dp;
    const int e = i - k * dp;
    sWr[k * ldw + e] = k < d && e < d ? Wr[k * d + e] : 0.f;
    sAcc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < (C + 1) * dp; i += blockDim.x) sDe[i] = 0.f;
  // the warps' buffers: components past d stay zeros where only the first
  // d of a row are staged
  for (int i = threadIdx.x; i < warps * wf; i += blockDim.x) sWarps[i] = 0.f;
  __syncthreads();

  const int nb = (B - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int items = nb * Tn;
  for (int first = 0; first < items; first += warps) {
    const int item = first + warp;
    if (item < items) {
      const int bi = item / Tn;
      const int t = item - bi * Tn;
      const long long b = blockIdx.x + (long long)bi * gridDim.x;
      const long long bt = b * Tn + t;
      // the item's global loads in two waves: the mask bytes and the small
      // vectors of the (b, t) and of its first chunk of candidates, all at
      // once; then all of their rows at once (16-byte staging)
      float gu[kChunk][Q], gi[kChunk][Q], ei_c[kChunk][Q], v[kChunk][Q];
      float inv_i[kChunk];
      unsigned long long imask[kChunk];
      bool mlo[kChunk], mhi[kChunk];
      auto small_loads = [&](int c0, int nc) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
#pragma unroll
          for (int q = 0; q < Q; ++q) gu[c][q] = gi[c][q] = ei_c[c][q] = 0.f;
          mlo[c] = mhi[c] = false;
          if (c < nc) {
            const long long bct = (b * C + c0 + c) * Tn + t;
            ldg_q<T, Q>(gu[c], dcu + bct * d, e0, d, vec);
            ldg_q<T, Q>(gi[c], dci + bct * d, e0, d, vec);
            if (target_aware) {
              ldg_q<T, Q>(ei_c[c], ei + (b * C + c0 + c) * d, e0, d, vec);
            }
            mlo[c] = lane < m && mi[bct * m + lane];
            mhi[c] = lane + 32 < m && mi[bct * m + lane + 32];
          }
        }
      };
      auto item_bits = [&]() {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          imask[c] = ((unsigned long long)__ballot_sync(kFull, mhi[c]) << 32) |
                     __ballot_sync(kFull, mlo[c]);
          inv_i[c] = kMean ? 1.f / fmaxf((float)__popcll(imask[c]), 1.f) : 1.f;
        }
      };
      const bool ulo = lane < n && mu[bt * n + lane];
      const bool uhi = lane + 32 < n && mu[bt * n + lane + 32];
      float eu_b[Q], em[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) eu_b[q] = em[q] = 0.f;
      if (target_aware) ldg_q<T, Q>(eu_b, eu + b * d, e0, d, vec);
      const int nc0 = min(kChunk, C);
      small_loads(0, nc0);
      const unsigned long long umask =
          ((unsigned long long)__ballot_sync(kFull, uhi) << 32) |
          __ballot_sync(kFull, ulo);
      item_bits();
      const float inv_u =
          kMean ? 1.f / fmaxf((float)__popcll(umask), 1.f) : 1.f;
      if (vec16) {   // the user rows and the first chunk's, in sEu, sEi
        const T* src = Ei + (b * C * Tn + t) * m * d;
        stage_rows_v<T, Q>(sEu, Eu + bt * n * d, umask, n, src, imask[0],
                           n + m, src + (long long)Tn * m * d, imask[1],
                           n + nc0 * m, d, lane);
        __syncwarp();
        sum_rows<Q>(em, sEu, n, e0);
      } else {
        stage_rows_q<T, Q>(sEu, Eu + bt * n * d, umask, n, d, e0, vec, em);
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) em[q] *= inv_u;
      sts_q<Q>(sVec + e0, em);
      __syncwarp();
      float w[Q];
      {
        float o[1][Q];
        x_wr<Q, 1>(o, sVec, sWr, kd4, e0);
#pragma unroll
        for (int q = 0; q < Q; ++q) w[q] = o[0][q] + eu_b[q];
      }

      float dw[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) dw[q] = 0.f;
      // gu and v keep the last chunk's, which the dEu pass reads
      for (int c0 = 0; c0 < C; c0 += kChunk) {
        const int nc = min(kChunk, C - c0);
        const bool last = c0 + kChunk >= C;
        __syncwarp();   // the last chunk's reads of the warp's buffers
        float es[kChunk][Q];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
#pragma unroll
          for (int q = 0; q < Q; ++q) es[c][q] = 0.f;
        if (c0 > 0) {   // the first chunk's came with the user rows
          small_loads(c0, nc);
          item_bits();
          if (vec16) {
            const T* src = Ei + ((b * C + c0) * Tn + t) * m * d;
            stage_rows_v<T, Q>(sEi, nullptr, 0, 0, src, imask[0], m,
                               src + (long long)Tn * m * d, imask[1],
                               nc * m, d, lane);
          }
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c < nc) {
            const long long bct = (b * C + c0 + c) * Tn + t;
            if (vec16) {
              sum_rows<Q>(es[c], sEi + c * m * dp, m, e0);
            } else {
              stage_rows_q<T, Q>(sEi + c * m * dp, Ei + bct * m * d,
                                 imask[c], m, d, e0, vec, es[c]);
            }
#pragma unroll
            for (int q = 0; q < Q; ++q) es[c][q] *= inv_i[c];
            sts_q<Q>(sRows + (2 * (c0 + c) + 1) * dp + e0, es[c]);
          }
          sts_q<Q>(sVec + c * dp + e0, es[c]);
        }
        __syncwarp();
        // v_c = Es_c Wr^T (+ ei_bc)
        wr_x<Q, kChunk>(v, sVec, sVec + kChunk * dp, sWr, kd4, lane, e0);
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
#pragma unroll
          for (int q = 0; q < Q; ++q) v[c][q] += ei_c[c][q];
        // the dots, 32 a transposing butterfly: su = s Eu_j . v_c and
        // da = Eu_j . dcu_c for 8 user rows and both candidates; then si =
        // s Ei_ck . w and db = Ei_ck . dci_c for 16 item rows
        for (int j0 = 0; j0 < n; j0 += 8) {
          float p[32];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            float x[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q) x[q] = 0.f;
            if (j0 + r < n) lds_q<Q>(x, sEu + (j0 + r) * dp + e0);
            p[4 * r] = dot_q<Q>(x, v[0]);
            p[4 * r + 1] = dot_q<Q>(x, gu[0]);
            p[4 * r + 2] = dot_q<Q>(x, v[1]);
            p[4 * r + 3] = dot_q<Q>(x, gu[1]);
          }
          const float s = transpose_sum<32>(p, lane);
          const int j = j0 + (lane >> 2);
          const int c = (lane >> 1) & 1;
          const int kind = lane & 1;
          if (j < n && c < nc) {
            sDot[(kind * kChunk + c) * n + j] = kind ? s : s * scale;
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c >= nc) break;
          for (int k0 = 0; k0 < m; k0 += 16) {
            float p[32];
#pragma unroll
            for (int r = 0; r < 16; ++r) {
              float x[Q];
#pragma unroll
              for (int q = 0; q < Q; ++q) x[q] = 0.f;
              if (k0 + r < m) lds_q<Q>(x, sEi + (c * m + k0 + r) * dp + e0);
              p[2 * r] = dot_q<Q>(x, w);
              p[2 * r + 1] = dot_q<Q>(x, gi[c]);
            }
            const float s = transpose_sum<32>(p, lane);
            const int k = k0 + (lane >> 1);
            const int kind = lane & 1;
            if (k < m) sDotI[(kind * kChunk + c) * m + k] = kind ? s : s * scale;
          }
        }
        __syncwarp();
        // the four softmaxes (user and item side of both candidates) and
        // their gradients: a, s dsu into sAU; b, s dsi into sBI. Up to 16
        // rows a side, candidate c's rows lie in half-warp c, j = lane % 16
        // (a row a lane, 4 shuffles a reduction); else rows lane and
        // lane + 32 of each of the four
        if (n <= 16 && m <= 16) {
          const int c = lane >> 4;
          const int j = lane & 15;
          const unsigned long long ibits = c ? imask[1] : imask[0];
          float a[2][2] = {}, g[2][2] = {};
          bool ok[2][2] = {};
          ok[0][0] = c < nc && j < n && ((umask >> j) & 1);
          ok[1][0] = c < nc && j < m && ((ibits >> j) & 1);
          if (ok[0][0]) {
            a[0][0] = sDot[c * n + j];
            g[0][0] = sDot[(kChunk + c) * n + j];
          }
          if (ok[1][0]) {
            a[1][0] = sDotI[c * m + j];
            g[1][0] = sDotI[(kChunk + c) * m + j];
          }
          softmax_groups<2, 16>(a, g, ok, scale);
          if (j < n) {
            sAU[4 * j + 2 * c] = a[0][0];
            sAU[4 * j + 2 * c + 1] = g[0][0];
          }
          if (c < nc && j < m) {
            sBI[2 * (c * m + j)] = a[1][0];
            sBI[2 * (c * m + j) + 1] = g[1][0];
          }
        } else {
          float a[2 * kChunk][2], g[2 * kChunk][2];
          bool ok[2 * kChunk][2];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = lane + 32 * r;
              ok[c][r] = c < nc && j < n && ((umask >> j) & 1);
              a[c][r] = ok[c][r] ? sDot[c * n + j] : 0.f;
              g[c][r] = ok[c][r] ? sDot[(kChunk + c) * n + j] : 0.f;
              ok[kChunk + c][r] = c < nc && j < m && ((imask[c] >> j) & 1);
              a[kChunk + c][r] = ok[kChunk + c][r] ? sDotI[c * m + j] : 0.f;
              g[kChunk + c][r] =
                  ok[kChunk + c][r] ? sDotI[(kChunk + c) * m + j] : 0.f;
            }
          }
          softmax_groups<2 * kChunk>(a, g, ok, scale);
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = lane + 32 * r;
              if (j < n) {
                sAU[4 * j + 2 * c] = a[c][r];
                sAU[4 * j + 2 * c + 1] = g[c][r];
              }
              if (c < nc && j < m) {
                sBI[2 * (c * m + j)] = a[kChunk + c][r];
                sBI[2 * (c * m + j) + 1] = g[kChunk + c][r];
              }
            }
          }
        }
        __syncwarp();
        // dv_c = s sum_j dsu_jc Eu_j; with more chunks to come, this
        // chunk's sum_c [a_jc dcu_c + s dsu_jc v_c] into sdEu
        float dv[kChunk][Q];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
#pragma unroll
          for (int q = 0; q < Q; ++q) dv[c][q] = 0.f;
        // (a masked row is zeros with zero weights: no branch skips it, so
        // that the unrolled loop keeps several rows' loads in flight)
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const float4 A = *reinterpret_cast<const float4*>(sAU + 4 * j);
          float x[Q];
          lds_q<Q>(x, sEu + j * dp + e0);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            dv[0][q] = fmaf(A.y, x[q], dv[0][q]);
            dv[1][q] = fmaf(A.w, x[q], dv[1][q]);
          }
          if (!last) {
            float acc[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q) acc[q] = 0.f;
            if (c0 > 0) lds_q<Q>(acc, sdEu + j * dp + e0);
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              acc[q] += A.x * gu[0][q] + A.y * v[0][q] + A.z * gu[1][q] +
                        A.w * v[1][q];
            }
            sts_q<Q>(sdEu + j * dp + e0, acc);
          }
        }
        // dw += s sum_ck dsi_ck Ei_ck
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c >= nc) break;
#pragma unroll 4
          for (int k = 0; k < m; ++k) {
            const float ds = sBI[2 * (c * m + k) + 1];
            float x[Q];
            lds_q<Q>(x, sEi + (c * m + k) * dp + e0);
#pragma unroll
            for (int q = 0; q < Q; ++q) dw[q] = fmaf(ds, x[q], dw[q]);
          }
        }
        // through v = Es Wr^T: dEs_c = dv_c Wr [/ cnt_i]; then dEi_ck =
        // mi_ck (b_ck dci_c + s dsi_ck w + dEs_c)
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          sts_q<Q>(sVec + c * dp + e0, dv[c]);
          if (c < nc) sts_q<Q>(sRows + 2 * (c0 + c) * dp + e0, dv[c]);
        }
        __syncwarp();
        float des[kChunk][Q];
        x_wr<Q, kChunk>(des, sVec, sWr, kd4, e0);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c >= nc) break;
          const long long bct = (b * C + c0 + c) * Tn + t;
#pragma unroll 4
          for (int k = 0; k < m; ++k) {
            float o[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q) o[q] = 0.f;
            if ((imask[c] >> k) & 1) {
              const float2 bk =
                  *reinterpret_cast<const float2*>(sBI + 2 * (c * m + k));
#pragma unroll
              for (int q = 0; q < Q; ++q) {
                o[q] = bk.x * gi[c][q] + bk.y * w[q] + des[c][q] * inv_i[c];
              }
            }
            stg_q<T, Q>(dEi + (bct * m + k) * d, o, e0, d, vec);
          }
        }
      }

      // through w = Em Wr: dEm = Wr dw [/ cnt_u]; dEu_j = mu_j (sum over
      // the candidates + dEm)
      __syncwarp();
      sts_q<Q>(sVec + e0, dw);
      sts_q<Q>(sRows + 2 * C * dp + e0, em);
      sts_q<Q>(sRows + (2 * C + 1) * dp + e0, dw);
      __syncwarp();
      float dem[1][Q];
      wr_x<Q, 1>(dem, sVec, sVec + kChunk * dp, sWr, kd4, lane, e0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float o[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) o[q] = 0.f;
        if ((umask >> j) & 1) {
          const float4 A = *reinterpret_cast<const float4*>(sAU + 4 * j);
          if (C > kChunk) lds_q<Q>(o, sdEu + j * dp + e0);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            o[q] += A.x * gu[0][q] + A.y * v[0][q] + A.z * gu[1][q] +
                    A.w * v[1][q] + dem[0][q] * inv_u;
          }
        }
        stg_q<T, Q>(dEu + (bt * n + j) * d, o, e0, d, vec);
      }
    }
    __syncthreads();

    // the round's items, in order: dWr += X^T Y over their rows, each
    // thread its own 4 x 4 tiles of the accumulator
    const int active = min(warps, items - first);
    const int rows_at = (n + kChunk * m + 2 * kChunk) * dp;   // sRows
    for (int tile = threadIdx.x; tile < tside * tside; tile += blockDim.x) {
      const int i0 = (tile / tside) * 4;
      const int j0 = (tile % tside) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(sAcc + (i0 + i) * dp + j0);
        acc[i][0] = a.x; acc[i][1] = a.y; acc[i][2] = a.z; acc[i][3] = a.w;
      }
      // rows z = (wi, r) of the round in order, unrolled so that several
      // rows' loads are in flight
      const int zrows = active * (C + 1);
      const float* row = sWarps + rows_at;
      int r = 0;
#pragma unroll 4
      for (int z = 0; z < zrows; ++z) {
        const float4 x = *reinterpret_cast<const float4*>(row + i0);
        const float4 y = *reinterpret_cast<const float4*>(row + dp + j0);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
        // the next row: the item's next, or the next item's first
        const bool next_item = ++r > C;
        row += next_item ? wf - 2 * C * dp : 2 * dp;
        r = next_item ? 0 : r;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(sAcc + (i0 + i) * dp + j0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    // dei_c = sum_t dv_c, deu = sum_t dw, in t order, written out with each
    // b's last t
    for (int i = threadIdx.x; i < (C + 1) * dp; i += blockDim.x) {
      const int r = i / dp;
      const int k = i - r * dp;
      float acc = sDe[i];
      for (int wi = 0; wi < active; ++wi) {
        acc += sWarps[wi * wf + rows_at + (2 * r + (r == C)) * dp + k];
        const int it = first + wi;
        const int bi = it / Tn;
        if (it - bi * Tn == Tn - 1) {
          if (k < d) {
            const long long b = blockIdx.x + (long long)bi * gridDim.x;
            const T out = from_f32<T>(target_aware ? acc : 0.f);
            if (r < C) {
              dei[(b * C + r) * d + k] = out;
            } else {
              deu[b * d + k] = out;
            }
          }
          acc = 0.f;
        }
      }
      sDe[i] = acc;
    }
    __syncthreads();
  }
  if (acc_smem) {
    for (int i = threadIdx.x; i < dp * dp; i += blockDim.x) part[i] = sAcc[i];
  }
}

// out[i][j] = sum_g part[g][i][j] for i, j < d, in the order g = 0, 1, ...
// (part: G blocks' [dp][dp] partials).
__global__ void wide_sum_partials_kernel(const float* __restrict__ part,
                                         int G, int d, int dp,
                                         float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < d * d) {
    const int i = e / d;
    const float* p = part + i * dp + (e - i * d);
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += p[(long long)g * dp * dp];
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

bool wide_shape_ok(int n, int m, int d) {
  return d >= 1 && d <= kWideMaxD && n >= 1 && n <= kWideMaxRows && m >= 1 &&
         m <= kWideMaxRows;
}

// The backward's launch: warps a block (at most bwd_max_warps, as many as
// shared memory holds next to the block's own buffers, and no more than
// there are items), its shared-memory bytes, and the grid (the blocks
// resident at once, at most B). The dWr accumulator goes to device memory
// where that lets more warps in (at d = 128: 7 warps an SM, not 4, which
// more than pays for its reads and writes in L2). Zero warps where one
// does not fit.
struct BwdPlan {
  int warps, smem, grid;
  bool acc_smem;   // the dWr accumulator in shared memory
};

template <typename Kernel>
BwdPlan bwd_plan(Kernel kernel, int B, int C, int Tn, int n, int m, int dp) {
  const int most = bwd_max_warps(dp / 32);
  const long long per_warp = bwd_warp_floats(n, m, dp, C);
  BwdPlan p = {0, 0, 0, true};
  for (bool acc_smem : {true, false}) {   // the dWr accumulator's place
    const long long block = bwd_block_floats(dp, C, acc_smem);
    long long w = (kSmemLimit / 4 - block) / per_warp;
    if (w > most) w = most;
    if (w > (long long)B * Tn) w = (long long)B * Tn;
    if (w <= p.warps) continue;   // shared memory only where it holds as many
    p.warps = (int)w;
    p.acc_smem = acc_smem;
    p.smem = (int)(4 * (block + w * per_warp));
  }
  if (p.warps > 0) p.grid = grid_for(kernel, p.warps * 32, p.smem, B);
  return p;
}

template <typename T, bool kMean, int Q>
int bwd_launch(int vec_io, const void* Eu, const void* Ei, const void* mu,
               const void* mi, const float* Wr, const void* eu,
               const void* ei, const void* dcu, const void* dci, void* dEu,
               void* dEi, void* deu, void* dei, float* dWr_part,
               long long scratch, float* dWr, int B, int C, int Tn, int n,
               int m, int d, int target_aware, long long* scratch_only,
               cudaStream_t stream) {
  constexpr int dp = 32 * Q;
  auto kernel = wide_bwd_kernel<T, kMean, Q>;
  const BwdPlan p = bwd_plan(kernel, B, C, Tn, n, m, dp);
  const long long need = (long long)p.grid * dp * dp;
  if (scratch_only != nullptr) {
    *scratch_only = p.warps < 1 ? 0 : need;
    return 0;
  }
  if (p.warps < 1 || need > scratch) return (int)cudaErrorInvalidValue;
  kernel<<<p.grid, p.warps * 32, p.smem, stream>>>(
      (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi, Wr,
      (const T*)eu, (const T*)ei, (const T*)dcu, (const T*)dci, (T*)dEu,
      (T*)dEi, (T*)deu, (T*)dei, dWr_part, B, C, Tn, n, m, d, target_aware,
      vec_io, (int)p.acc_smem, 1.0f / sqrtf((float)d));
  wide_sum_partials_kernel<<<(d * d + 255) / 256, 256, 0, stream>>>(
      dWr_part, p.grid, d, dp, dWr);
  return (int)cudaGetLastError();
}

// Components a lane: the fewest of 1, 2 and 4 that cover d over 32 lanes.
int lane_width(int d) { return d <= 32 ? 1 : d <= 64 ? 2 : 4; }

template <typename T, bool kMean>
int bwd_width(int Q, int vec_io, const void* Eu, const void* Ei, const void* mu,
              const void* mi, const float* Wr, const void* eu, const void* ei,
              const void* dcu, const void* dci, void* dEu, void* dEi,
              void* deu, void* dei, float* dWr_part, long long scratch,
              float* dWr, int B, int C, int Tn, int n, int m, int d,
              int target_aware, long long* scratch_only, cudaStream_t s) {
#define WIDE_BWD(QQ)                                                         \
  bwd_launch<T, kMean, QQ>(vec_io, Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu,   \
                           dEi, deu, dei, dWr_part, scratch, dWr, B, C, Tn,  \
                           n, m, d, target_aware, scratch_only, s)
  return Q == 1 ? WIDE_BWD(1) : Q == 2 ? WIDE_BWD(2) : WIDE_BWD(4);
#undef WIDE_BWD
}

// pool: 0 = sum, 1 = mean. dtype as wide_fwd (also dcu, dci and the
// gradients dEu, dEi, deu, dei). Wr and dWr are f32; dWr_part, f32 scratch
// of `scratch` floats, takes the blocks' partials (at least
// wide_bwd_scratch_floats). B, C and T must be >= 1. scratch_only: only the
// scratch floats the shape needs, into *scratch_only (0: no launch fits).
int bwd_entry(const void* Eu, const void* Ei, const void* mu, const void* mi,
              const float* Wr, const void* eu, const void* ei,
              const void* dcu, const void* dci, void* dEu, void* dEi,
              void* deu, void* dei, float* dWr_part, long long scratch,
              float* dWr, int B, int C, int Tn, int n, int m, int d,
              int target_aware, int pool, int dtype,
              long long* scratch_only, cudaStream_t s) {
  if (!wide_shape_ok(n, m, d) || B < 1 || C < 1 || Tn < 1 || dtype < 0 ||
      dtype > 1 || pool < 0 || pool > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int Q = lane_width(d);
  const uintptr_t step = (uintptr_t)Q * (dtype == 0 ? 4 : 2) - 1;
  bool vec = d % Q == 0;
  for (const void* p : {Eu, Ei, eu, ei, dcu, dci, (const void*)dEu,
                        (const void*)dEi}) {
    vec = vec && ((uintptr_t)p & step) == 0;
  }
  const bool vec16 = d * (dtype == 0 ? 4 : 2) % 16 == 0 &&
                     aligned16(Eu) && aligned16(Ei);
  const int vec_io = (vec ? 1 : 0) | (vec16 ? 2 : 0);
#define WIDE_BWD(T, MEAN)                                                    \
  bwd_width<T, MEAN>(Q, vec_io, Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu, dEi, \
                     deu, dei, dWr_part, scratch, dWr, B, C, Tn, n, m, d,    \
                     target_aware, scratch_only, s)
  if (dtype == 0) return pool == 1 ? WIDE_BWD(float, true) : WIDE_BWD(float, false);
  return pool == 1 ? WIDE_BWD(__nv_bfloat16, true)
                   : WIDE_BWD(__nv_bfloat16, false);
#undef WIDE_BWD
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

extern "C" int wide_bwd(const void* Eu, const void* Ei, const void* mu,
                        const void* mi, const float* Wr, const void* eu,
                        const void* ei, const void* dcu, const void* dci,
                        void* dEu, void* dEi, void* deu, void* dei,
                        float* dWr_part, long long scratch, float* dWr, int B,
                        int C, int Tn, int n, int m, int d, int target_aware,
                        int pool, int dtype, void* stream) {
  return bwd_entry(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, dEu, dEi, deu, dei,
                   dWr_part, scratch, dWr, B, C, Tn, n, m, d, target_aware,
                   pool, dtype, nullptr, (cudaStream_t)stream);
}

// The f32 scratch wide_bwd needs at this shape (its blocks' partials of
// dWr), or -1 for a shape it does not take.
extern "C" long long wide_bwd_scratch_floats(int B, int C, int Tn, int n,
                                             int m, int d, int pool,
                                             int dtype) {
  long long floats = 0;
  const int err = bwd_entry(nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, 0, nullptr,
                            B, C, Tn, n, m, d, 0, pool, dtype, &floats,
                            nullptr);
  return err != 0 || floats < 1 ? -1 : floats;
}

extern "C" const char* coattn_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
