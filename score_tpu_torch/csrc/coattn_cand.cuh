// The co-attention forward in the candidates form, for the sum, mean and
// max pools: the user side Eu [B, T, n, d] is shared by C candidates
// Ei [B, C, T, m, d] and read once a (b, t). Included by coattn_cand.cu
// (the sum pool, `cand_fwd`, for score_tpu/kernels/coattn_cand.py:
// _cand_fwd) and coattn_pair.cu (all three, `pair_fwd`, for
// score_tpu/kernels/coattn.py:_coattn_fwd_pallas); their notes list the
// ptxas registers of each instance.
//
// Math, for each (b, c, t), s = 1/sqrt(d), EuW = Eu Wr ([n, d]):
//   sum/mean: Es = sum_k mi_k Ei_ck, Ew = sum_j mu_j EuW_j, each divided
//             by max(valid count, 1) for the mean; with w = Ew (+ eu_b if
//             target-aware) and v = Es Wr^T (+ ei_bc):
//             su_j = s Eu_j . v        si_k = s Ei_ck . w
//   max:      M_jk = s EuW_j . Ei_ck over the valid (j, k) pairs;
//             su_j = max_k M_jk, or 0 if no k is valid;
//             si_k = max_j M_jk, or 0 if no j is valid;
//             target-aware: su_j += s Eu_j . ei_bc, si_k += s Ei_ck . eu_b
//   a = masked softmax of su (mask mu), b = masked softmax of si (mask mi)
//   cu = sum_j a_j Eu_j,  ci = sum_k b_k Ei_ck
// A row with no valid entry gives exact zeros, not NaN.
//
// Bound on the H100: bytes. Per (b, c, t) the kernel must read the valid
// rows of Ei (m*d values) and write 2*d outputs; EuW once a (b, t) is
// 2*n*d*d operations and the rest about 4*(n+m)*d (sum, mean) or
// 2*n*m*d (max) a unit: under 40 operations a byte at bf16, far below the
// card's ~295 at its tensor-core peak (~20 at the f32 CUDA-core peak,
// which the max pool's relation matrix would reach on the CUDA cores).
// Issue, latency and shuffles are what the design has to keep down; for
// the max pool also the tensor pipe, where each mma.sync costs about as
// much issue time as ten ALU instructions.
//
// Sum and mean: a group of 4 lanes owns one (b, c, t) unit; lane q holds
// components [8q, 8q+8) of every d-vector (d <= 32). A row is one
// 16-byte load a lane in bf16 (two in f32), a dot is 8 FMAs in the lane
// and a 2-step shuffle in the group, and one warp instruction computes
// the exponentials of 8 units' scores. The softmaxes go a batch of kRows
// rows at a time: the batch's max first, then one exponential a row, f32
// throughout, in log2 units (1/sqrt(d) * log2(e) folded into w, EuW and
// v). The mean is the sum with the masked user sum scaled before w is
// formed and the unit's item sum before it enters the user side.
//
// Max: one warp owns one unit at a time, and the relation matrix is a
// tensor-core product: A = EuW of the unit's (b, t), rows padded to 16
// (32), staged once a (b, t) in fragment order (kAWords), B = the
// candidate's Ei rows as n-tiles of 8. The d index is permuted inside
// each lane's 8 components, so that lane (g = lane / 4, q = lane % 4)
// feeds every k-step from components [8q, 8q+8) of item rows g and g + 8
// (and g + 16, g + 24): one 16-byte load a row serves all the k-steps.
// bf16 inputs, m16n8k16 tiles: Ei is exact in bf16, and EuW (f32) is
// staged split as hi = bf16(x), lo = bf16(x - hi), two products;
// |x - hi - lo| <= 2^-18 |x|, so each M_jk is within ~2^-18 sum_l
// |EuW_jl Ei_kl| (plus f32 accumulation) of the f32 value, and EuW itself
// (Eu exact, Wr split the same way) within ~2^-17 of its f32 value.
// f32 inputs, 3xTF32 on m16n8k8 tiles: both operands split into tf32
// hi + lo, hi*hi + hi*lo + lo*hi; the split leaves 2^-22 |x| and the
// dropped lo*lo 2^-22 |x y|, so M_jk is within ~2^-20 sum_l |EuW_jl
// Ei_kl| (EuW by f32 FMAs on the CUDA cores). The accumulators start at
// the mask biases (0 on a valid row or column, -1e9 elsewhere, a side
// with no valid entry keeping its zero first row or column so that the
// other side's maxima come out 0), and leave M_jk at (row g or g + 8,
// column 2q or 2q + 1): a row max is 2 shuffles within the quad, the
// column maxima one transposing max of 3 shuffles across it and one more
// to the lane that holds each item row, ~12 shuffles a unit where the
// warp-per-(b, t) design took ~310. In bf16 the target terms (eu and ei
// are exact in bf16) are two more small products, Eu ei and eu Ei, and
// the softmax-weighted sums run on the tensor cores too: the rows,
// transposed by movmatrix, are B, and A's rows 0-7 and 8-15 are the
// weights' hi and lo bf16 parts; in f32 both run on the CUDA cores. Each
// warp's next unit's item rows and ei are loaded while it works on the
// current one, in two register buffers taken in turn.
//
// Grid (all pools): a block owns a tile of candidates of one b over all
// t, or, when one tile holds all C, several b's. Per (b, t) pair it stages
// once, in shared memory: the valid Eu rows, the user-mask bits, the
// units' item-mask bits, and, as the pool needs, w, EuW = Eu @ Wr (sum
// and mean when the tile holds at least n candidates; narrower tiles form
// v per unit from Wr^T, 32 shuffles gathering isum over the group) or
// the split A fragments (max, on the tensor cores for bf16), and for the
// max pool each unit's place. Units go candidate-fastest, so a warp's
// units mostly share their (b, t). The tile is taken from B and C so
// that at least 2 x 132 blocks run where B * C allows (max: up to one
// wave of 4 x 132), at most 64 candidates a block; the launch bounds hold
// 4 blocks of 128 threads on an SM. Masks
// arrive as bytes and become bit sets; rows a mask excludes are never
// read. The 16-byte path needs rows of a multiple of 16 bytes and
// 16-byte-aligned inputs; anything else (d = 7, an offset view) takes the
// scalar path of the same kernel.

#pragma once

#include <type_traits>

#include "coattn_common.cuh"

namespace {

enum Pool { kSum = 0, kMean = 1, kMax = 2 };

constexpr int kGroup = 4;        // lanes a unit
constexpr int kComp = 8;         // components a lane (kGroup * kComp = 32)
constexpr int kPad = 32;         // shared-memory row width, in floats
constexpr int kMaxThreads = 128;
constexpr int kBlocksPerSm = 4;  // caps registers at 128 a thread
constexpr int kMaxTile = 64;     // candidates a block
constexpr int kMinBlocks = 2 * 132;
// a max-pool warp works one unit at a time: it wants every SM's 4 blocks,
// but in one wave (a second, partial wave of its long blocks costs more
// than a few idle slots: B=256 C=101, 768 blocks, 1.2x slower than 512)
constexpr int kMinBlocksMax = 4 * 132;
constexpr int kChunkBytes = 40 * 1024;   // shared memory for the pairs
constexpr int kUnitsPerBlock = 128;
constexpr int kRows = 5;         // rows a softmax batch, item and user side
constexpr float kLog2e = 1.4426950408889634f;

// A row's 8 components of one lane, as loaded (converted when used).
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 v; };
template <> struct Raw<float> { float4 a, b; };

template <bool VEC>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* row, int l0,
                                         int d, bool ok,
                                         Raw<__nv_bfloat16>& r) {
  r.v = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (ok && l0 < d) r.v = __ldg(reinterpret_cast<const uint4*>(row + l0));
  } else {
    unsigned h[kComp];
#pragma unroll
    for (int i = 0; i < kComp; ++i) {
      h[i] = (ok && l0 + i < d) ? __bfloat16_as_ushort(row[l0 + i]) : 0u;
    }
    r.v = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                     h[6] | h[7] << 16);
  }
}

template <bool VEC>
__device__ __forceinline__ void load_raw(const float* row, int l0, int d,
                                         bool ok, Raw<float>& r) {
  r.a = r.b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (ok && l0 < d) r.a = __ldg(reinterpret_cast<const float4*>(row + l0));
    if (ok && l0 + 4 < d) {
      r.b = __ldg(reinterpret_cast<const float4*>(row + l0 + 4));
    }
  } else {
    float x[kComp];
#pragma unroll
    for (int i = 0; i < kComp; ++i) {
      x[i] = (ok && l0 + i < d) ? row[l0 + i] : 0.f;
    }
    r.a = make_float4(x[0], x[1], x[2], x[3]);
    r.b = make_float4(x[4], x[5], x[6], x[7]);
  }
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r,
                                       float x[kComp]) {
  const unsigned w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float x[kComp]) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}

template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* row, int l0, int d,
                                       const float y[kComp]) {
  if (VEC) {
    if (l0 >= d) return;
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&p);
    }
    *reinterpret_cast<uint4*>(row + l0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kComp; ++i) {
      if (l0 + i < d) row[l0 + i] = __float2bfloat16(y[i]);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(float* row, int l0, int d,
                                       const float y[kComp]) {
  if (VEC) {
    if (l0 < d) {
      *reinterpret_cast<float4*>(row + l0) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
    if (l0 + 4 < d) {
      *reinterpret_cast<float4*>(row + l0 + 4) =
          make_float4(y[4], y[5], y[6], y[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kComp; ++i) {
      if (l0 + i < d) row[l0 + i] = y[i];
    }
  }
}

// the lane's 8 components of a 32-float shared-memory row
__device__ __forceinline__ void lds8(const float* p, float x[kComp]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float dot8(const float x[kComp],
                                      const float y[kComp], float s) {
#pragma unroll
  for (int i = 0; i < kComp; ++i) s = fmaf(x[i], y[i], s);
  return s;
}

// sum over the 4 lanes of a group (every lane of the warp takes part)
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Masked softmax-weighted sum of 8-component rows, a batch of rows at a
// time: begin() takes the batch's largest valid score and rescales what
// came before (once a batch), then add() weighs each row with one
// exponential. Scores are in log2 units (1/sqrt(d) times log2(e) is
// folded into w, EuW and v). An invalid row weighs 0; with no
// valid row, acc = sum = 0 and the result is exact zeros. The same value
// as the reference's where(-1e9) / subtract-max / exp * mask / divide by
// max(sum, 1e-20).
struct Softmax8 {
  float mx = kNeg, sum = 0.f, acc[kComp] = {};
  __device__ __forceinline__ void begin(float batch_max) {
    const float nm = fmaxf(mx, batch_max);
    const float r = fast_exp2(mx - nm);
    sum *= r;
#pragma unroll
    for (int i = 0; i < kComp; ++i) acc[i] *= r;
    mx = nm;
  }
  __device__ __forceinline__ void add(float s, const float x[kComp],
                                      bool valid) {
    const float e = valid ? fast_exp2(s - mx) : 0.f;
    sum += e;
#pragma unroll
    for (int i = 0; i < kComp; ++i) acc[i] = fmaf(e, x[i], acc[i]);
  }
  __device__ __forceinline__ void result(float y[kComp]) const {
    const float inv = 1.0f / fmaxf(sum, 1e-20f);
#pragma unroll
    for (int i = 0; i < kComp; ++i) y[i] = acc[i] * inv;
  }
};

// Launch geometry. A block owns nbb consecutive b's (more than one only
// when a tile holds all C candidates) and a tile of candidates, and stages
// its (b, t) pairs tchunk at a time.
struct Plan {
  int tile, ntile, nbb, tchunk, threads;
  bool euw;
  size_t smem;
};

// The max pool's A operand, EuW, is staged a pair at a time as mma
// fragments, [m-tile][k-step][lane][4 words]: one lane's operand is one
// 16-byte load, and a quarter warp's loads touch 32 distinct banks. Lane
// (g, q) holds rows 16 mt + g (words 0 and 2) and 16 mt + g + 8 (words 1
// and 3): in bf16, k-step s's components 8q + 4s + {0, 1} (words 0, 1)
// and 8q + 4s + {2, 3} (words 2, 3), as pairs; in tf32, component 8q + 2s
// (words 0, 1) and 8q + 2s + 1 (words 2, 3). A row is kAWords words.
template <typename T> constexpr int kAWords = 16;
template <> constexpr int kAWords<float> = 32;

// The max pool's tiles: 16 rows and columns, or 32 where n or m needs it.
inline int max_rows(int n, int m) { return n > 16 || m > 16 ? 32 : 16; }

template <typename T, int POOL>
Plan plan(int B, int C, int Tn, int n, int m) {
  Plan p;
  const long long minb = POOL == kMax ? kMinBlocksMax : kMinBlocks;
  const long long want =   // tiles a b wanted
      POOL == kMax ? minb / B : (minb + B - 1) / B;
  long long nt = (C + kMaxTile - 1) / kMaxTile;
  if (want > nt) nt = want < C ? want : C;
  p.tile = (int)((C + nt - 1) / nt);
  p.ntile = (C + p.tile - 1) / p.tile;
  // EuW = Eu @ Wr once a (b, t) costs n d x d rows; v per unit costs one
  // such row a candidate: stage EuW once the tile holds n candidates (the
  // max pool always stages it, as the split A rows)
  p.euw = POOL == kMax || p.tile >= n;
  // sum, mean: a pair's Eu rows (in T), EuW rows, w, masked sum and eu
  // (f32); max: its Eu rows (in T), eu (f32 and as A rows) and the A
  // operand's tiles, hi and lo; then its units' item-mask bit sets (max:
  // with where each unit lies), its user-mask bit set and mask bytes
  const int per_pair =
      (POOL == kMax ? n * kPad * (int)sizeof(T)
                        + 2 * max_rows(n, m) * kAWords<T> * 4 + 2 * kPad * 4
                    : n * kPad * (p.euw ? 8 : (int)sizeof(T)) + 3 * kPad * 4)
      + (POOL == kMax ? 16 : 4) * p.tile + 4 + n;
  const int fit = kChunkBytes / per_pair > 1 ? kChunkBytes / per_pair : 1;
  // small C: as many b's a block as keep minb blocks, about
  // kUnitsPerBlock units and one chunk
  long long nbb = 1;
  if (p.ntile == 1) {
    nbb = B / minb;
    const long long by_units = kUnitsPerBlock / ((long long)C * Tn);
    const long long by_smem = fit / Tn;
    if (by_units < nbb) nbb = by_units;
    if (by_smem < nbb) nbb = by_smem;
    if (nbb < 1) nbb = 1;
  }
  p.nbb = (int)nbb;
  const long long pairs = nbb * Tn;
  p.tchunk = (int)(pairs < fit ? pairs : fit);
  const long long units = (long long)p.tile * p.tchunk;
  if (POOL == kMax) {   // a warp a unit
    p.threads = (int)(units < kMaxThreads / 32 ? units : kMaxThreads / 32) * 32;
  } else {              // a group of 4 lanes a unit
    long long groups = (units + 7) / 8 * 8;
    if (groups > kMaxThreads / kGroup) groups = kMaxThreads / kGroup;
    p.threads = (int)groups * kGroup;
  }
  p.smem = (size_t)(2 * kPad * kPad) * 4 + (size_t)p.tchunk * per_pair;
  return p;
}

// Stop the compiler from reusing a value it computed before (the second
// pass over a batch re-derives each row instead of holding it).
__device__ __forceinline__ void launder(Raw<__nv_bfloat16>& r) {
  asm volatile("" : "+r"(r.v.x), "+r"(r.v.y), "+r"(r.v.z), "+r"(r.v.w));
}
__device__ __forceinline__ void launder(Raw<float>&) {}
template <typename P>
__device__ __forceinline__ P* launder_ptr(P* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ void lds_raw(const __nv_bfloat16* p,
                                        Raw<__nv_bfloat16>& r) {
  r.v = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void lds_raw(const float* p, Raw<float>& r) {
  r.a = reinterpret_cast<const float4*>(p)[0];
  r.b = reinterpret_cast<const float4*>(p)[1];
}
// Store a staged row part in shared memory, as S (bf16 rows stay bf16
// where S is T; f32 where S is float).
__device__ __forceinline__ void sts_conv(__nv_bfloat16* p,
                                         const Raw<__nv_bfloat16>& r) {
  *reinterpret_cast<uint4*>(p) = r.v;
}
__device__ __forceinline__ void sts_conv(float* p, const Raw<float>& r) {
  reinterpret_cast<float4*>(p)[0] = r.a;
  reinterpret_cast<float4*>(p)[1] = r.b;
}
__device__ __forceinline__ void sts_conv(float* p,
                                         const Raw<__nv_bfloat16>& r) {
  float x[kComp];
  unpack(r, x);
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// --- the max pool: a warp a unit, the relation matrix on tensor cores ---

// D += A B on one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A B on one m16n8k8 tile, tf32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float c[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// acc += A B over d for one tile: A's rows g and g + 8 as fragments
// staged by euw_mma or store_tf32 (fa[s * 32] is k-step s's), B's column
// g as lane (g, q)'s components [8q, 8q+8). A bf16 k-step s takes
// components 8q + 4s + {0, 1} as k = 2q + {0, 1} and 8q + 4s + {2, 3} as
// k = 2q + 8 + {0, 1}; a tf32 k-step s takes 8q + 2s as k = q and
// 8q + 2s + 1 as k = q + 4. Either way each k-step covers every component
// once, in A and in B alike, so the tile holds the dots over d.
__device__ __forceinline__ void mma_tile(float acc[4], const uint4* fa,
                                         const uint4& b) {
  const uint4 a0 = fa[0], a1 = fa[32];
  mma_bf16(acc, a0.x, a0.y, a0.z, a0.w, b.x, b.y);
  mma_bf16(acc, a1.x, a1.y, a1.z, a1.w, b.z, b.w);
}
__device__ __forceinline__ void mma_tile(float acc[4], const uint4* fa,
                                         const unsigned b[kComp]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint4 a = fa[32 * s];
    mma_tf32(acc, a.x, a.y, a.z, a.w, b[2 * s], b[2 * s + 1]);
  }
}

// acc += EuW x the item row, EuW as hi and lo fragments: bf16 items are
// exact, so hi and lo take one product each; f32 items are split too, and
// hi*hi + hi*lo + lo*hi (3xTF32).
__device__ __forceinline__ void relation_tile(float acc[4], const uint4* fh,
                                              const uint4* fl,
                                              const Raw<__nv_bfloat16>& b) {
  mma_tile(acc, fh, b.v);
  mma_tile(acc, fl, b.v);
}
__device__ __forceinline__ void relation_tile(float acc[4], const uint4* fh,
                                              const uint4* fl,
                                              const Raw<float>& b) {
  float x[kComp];
  unpack(b, x);
  unsigned h[kComp], l[kComp];
#pragma unroll
  for (int i = 0; i < kComp; ++i) {
    h[i] = to_tf32(x[i]);
    l[i] = to_tf32(x[i] - __uint_as_float(h[i]));
  }
  mma_tile(acc, fh, h);
  mma_tile(acc, fh, l);
  mma_tile(acc, fl, h);
}

// One step of a transposing max: v holds 2H values; lanes whose bit `o`
// is set keep the upper H, the others the lower H, each the max with its
// partner's copy.
template <int H>
__device__ __forceinline__ void fold_max(float* v, int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = fmaxf(keep, __shfl_xor_sync(kFull, send, o));
  }
}

// Masked softmax weights of the lane's NT rows (row 8i + g of slot i;
// scores replicated over the quad), unnormalised: e[i], and returns their
// sum over all rows. Scores in log2 units; no valid row gives e = 0 and
// sum 0.
template <int NT>
__device__ __forceinline__ float softmax_weights(const float s[NT],
                                                 const bool valid[NT],
                                                 float e[NT]) {
  float mx = kNeg;
#pragma unroll
  for (int i = 0; i < NT; ++i) mx = valid[i] ? fmaxf(mx, s[i]) : mx;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) e[i] = valid[i] ? fast_exp2(s[i] - mx) : 0.f;
  float sum = e[0];
#pragma unroll
  for (int i = 1; i < NT; ++i) sum += e[i];
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
  return sum;
}

// sum_i e[i] x_i over the lane's rows (f32, the CUDA cores): returns
// component 8q + g of the sum in lane (g, q).
template <int NT>
__device__ __forceinline__ float weighted_fold(const float e[NT],
                                               const float (*x)[kComp],
                                               int lane) {
  float acc[kComp] = {};
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int c = 0; c < kComp; ++c) acc[c] = fmaf(e[i], x[i][c], acc[c]);
  }
  // sum acc over the 8 lanes of each q; lane (g, q) keeps component g
  fold<4>(acc, lane, 16);
  fold<2>(acc, lane, 8);
  fold<1>(acc, lane, 4);
  return acc[0];
}

__device__ __forceinline__ unsigned movmatrix_t(unsigned x) {
  unsigned y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&x);
}

// sum_k e[k] x_k over the warp's 8 NT bf16 rows (slot i: row 8i + g, the
// lane's words of components [8q, 8q+8); e in slots too, replicated over
// q) on the tensor cores, in f32: y = components [8q, 8q+8) in every lane
// of q. A k-step takes 16 rows; A's rows 0-7 are the weights' bf16 hi
// parts and rows 8-15 their lo parts (within 2^-18 of f32), summed after
// the product; B is the rows transposed by movmatrix: word v of the
// lane's row parts, an 8 x 8 block whose column 2q + b is component
// 8q + 2v + b, becomes n-tile v, and D's column 2q + b of n-tile v is
// component 8q + 2v + b.
template <int NT>
__device__ __forceinline__ void weighted_mma(const float e[NT],
                                             const uint4 x[NT], int lane,
                                             float y[kComp]) {
  const int q = lane & 3;
  float acc[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    // the weights of rows 16 ks + 2q + {0, 1} and 16 ks + 8 + 2q + {0, 1}
    const float w0 = __shfl_sync(kFull, e[2 * ks], 8 * q);
    const float w1 = __shfl_sync(kFull, e[2 * ks], 8 * q + 4);
    const float w2 = __shfl_sync(kFull, e[2 * ks + 1], 8 * q);
    const float w3 = __shfl_sync(kFull, e[2 * ks + 1], 8 * q + 4);
    const unsigned h01 = bf16x2(w0, w1), h23 = bf16x2(w2, w3);
    const unsigned l01 =
        bf16x2(w0 - __uint_as_float(h01 << 16),
               w1 - __uint_as_float(h01 & 0xffff0000u));
    const unsigned l23 =
        bf16x2(w2 - __uint_as_float(h23 << 16),
               w3 - __uint_as_float(h23 & 0xffff0000u));
    const unsigned x0[4] = {x[2 * ks].x, x[2 * ks].y, x[2 * ks].z,
                            x[2 * ks].w};
    const unsigned x1[4] = {x[2 * ks + 1].x, x[2 * ks + 1].y,
                            x[2 * ks + 1].z, x[2 * ks + 1].w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const unsigned b0 = movmatrix_t(x0[v]), b1 = movmatrix_t(x1[v]);
      mma_bf16(acc[v], h01, l01, h23, l23, b0, b1);
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    y[2 * v] = acc[v][0] + acc[v][2];   // hi rows + lo rows
    y[2 * v + 1] = acc[v][1] + acc[v][3];
  }
}

// The max pool's A operand for bf16 inputs, EuW = Eu @ Wr, on the tensor
// cores: a warp per 16 rows of a pair. Eu (bf16, exact; rows past n are
// zeros) in the standard m16n8k16 A layout from its staged rows, Wr split
// hi + lo as B, f32 accumulators; each D pair (row j, components c, c + 1)
// is one word of the staged fragments (kAWords), written split hi + lo.
template <int MAXK>
__device__ __forceinline__ void euw_mma(const float* sWr,
                                        const __nv_bfloat16* sEu,
                                        unsigned* sAh, unsigned* sAl, int tt,
                                        int n) {
  constexpr int MT = MAXK / 16, W = kAWords<__nv_bfloat16>;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  // B: Wr rows 16s + 2q + {0, 1} (+ 8 for the second register), column
  // 8nt + g, hi and lo
  unsigned bh[4][2][2], bl[4][2][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 16 * s + 2 * q + 8 * r, l = 8 * nt + g;
        const float x0 = sWr[k * kPad + l], x1 = sWr[(k + 1) * kPad + l];
        bh[nt][s][r] = bf16x2(x0, x1);
        bl[nt][s][r] = bf16x2(x0 - __uint_as_float(bh[nt][s][r] << 16),
                              x1 - __uint_as_float(bh[nt][s][r] & 0xffff0000u));
      }
    }
  }
  for (int pm = warp; pm < tt * MT; pm += nw) {
    const int p = pm / MT, mt = pm - p * MT;
    const int j0 = 16 * mt + g, j1 = j0 + 8;
    const unsigned* r0 =
        reinterpret_cast<const unsigned*>(sEu + (p * n + j0) * kPad);
    const unsigned* r1 =
        reinterpret_cast<const unsigned*>(sEu + (p * n + j1) * kPad);
    unsigned a[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {   // components 16s + 2q (+ 8), as words
      a[s][0] = j0 < n ? r0[8 * s + q] : 0u;
      a[s][1] = j1 < n ? r1[8 * s + q] : 0u;
      a[s][2] = j0 < n ? r0[8 * s + q + 4] : 0u;
      a[s][3] = j1 < n ? r1[8 * s + q + 4] : 0u;
    }
    unsigned* ah = sAh + p * MAXK * W;
    unsigned* al = sAl + p * MAXK * W;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        mma_bf16(c, a[s][0], a[s][1], a[s][2], a[s][3], bh[nt][s][0],
                 bh[nt][s][1]);
        mma_bf16(c, a[s][0], a[s][1], a[s][2], a[s][3], bl[nt][s][0],
                 bl[nt][s][1]);
      }
      // components 8nt + 2q, +1 of rows j0 (h = 0) and j1 (h = 1): the
      // fragments' lane (g, nt), k-step q / 2, word 2 (q % 2) + h
      const int f = ((mt * 2 + (q >> 1)) * 32 + g * 4 + nt) * 4 + 2 * (q & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned hi = bf16x2(c[2 * h], c[2 * h + 1]);
        ah[f + h] = hi;
        al[f + h] = bf16x2(c[2 * h] - __uint_as_float(hi << 16),
                           c[2 * h + 1] - __uint_as_float(hi & 0xffff0000u));
      }
    }
  }
}

// Components l4 .. l4 + 3 of row j of EuW, split tf32 hi + lo, at their
// words of the staged fragments (the f32 inputs' A operand): lane
// (j % 8, l4 / 8), k-steps (l4 % 8) / 2 and one more, words 2e + h.
__device__ __forceinline__ void store_tf32(const float a[4], unsigned* ah,
                                           unsigned* al, int j, int l4) {
  const int r = j & 15, h = r >> 3, lane = (r & 7) * 4 + (l4 >> 3);
  const int f = (((j >> 4) * 4 + ((l4 & 7) >> 1)) * 32 + lane) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // components l4 + i: k-step i / 2
    const int w = f + (i >> 1) * 32 * 4 + 2 * (i & 1) + h;
    ah[w] = to_tf32(a[i]);
    al[w] = to_tf32(a[i] - __uint_as_float(ah[w]));
  }
}

// The max pool's units of one chunk, a warp each (warp-uniform loop).
// MAXK (16 or 32) bounds n and m: MT = MAXK / 16 m-tiles of user rows,
// NT = MAXK / 8 n-tiles of item rows; lane (g, q) holds user rows and item
// rows 8i + g (slot i < NT), components [8q, 8q+8). EuW is staged
// unscaled; the scores are taken to log2 units (times c2) at the end.
template <typename T, bool VEC, int MAXK>
__device__ __forceinline__ void max_units(
    const T* __restrict__ Ei, const T* __restrict__ ei, T* __restrict__ cu,
    T* __restrict__ ci, const int4* sUnit, const unsigned* sBits,
    const float* sEuv, const uint4* sEuF, const unsigned* sAh,
    const unsigned* sAl, const T* sEu, long long bc0, int Tn, int units,
    int n, int m, int d, int target_aware, float c2) {
  constexpr int MT = MAXK / 16, NT = MAXK / 8, W = kAWords<T>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int KS = BF16 ? 2 : 4;   // k-steps over d
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int l0 = q * kComp, nw = blockDim.x >> 5;
  int u = threadIdx.x >> 5;
  if (u >= units) return;
  // unit u: candidate row bc0 + x, slot y, pair z, item-mask bits w; its
  // item rows and its ei
  auto load_items = [&](const int4& in, Raw<T> rows[NT], Raw<T>& rei) {
    const T* Ei_u = Ei + ((bc0 + in.x) * Tn + in.y) * m * d;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int k = 8 * i + g;
      load_raw<VEC>(Ei_u + k * d, l0, d, (in.w >> k) & 1, rows[i]);
    }
    load_raw<VEC>(ei + (bc0 + in.x) * d, l0, d, target_aware, rei);
  };
  // one unit, its item rows and ei loaded
  auto unit = [&](const int4& in, const Raw<T> (&rows)[NT],
                  const Raw<T>& raw_ei) {
    const long long bct = (bc0 + in.x) * Tn + in.y;
    const unsigned bits = in.w, ubits = sBits[in.z];
    const int pl = in.z, row0 = pl * n;   // the pair's first staged row

    // biases: 0 on a valid row (column), kNeg elsewhere; a side with no
    // valid entry keeps its first row (column), all zeros, so that the
    // other side's maxima come out 0, as the reference's
    const unsigned ukeep = ubits ? ubits : 1u, ikeep = bits ? bits : 1u;
    float rb[NT], cb[NT][2];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      rb[i] = (ukeep >> (8 * i + g)) & 1u ? 0.f : kNeg;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cb[i][e] = (ikeep >> (8 * i + 2 * q + e)) & 1u ? 0.f : kNeg;
      }
    }
    // M + biases, tile by tile
    float acc[MT][NT][4];
    Raw<T> xr[NT];   // the user rows' parts (zeros past n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * mt + 8 * h + g;
        if (j < n) {
          lds_raw(sEu + (row0 + j) * kPad + l0, xr[2 * mt + h]);
        } else {
          load_raw<false>(sEu, 0, 0, false, xr[2 * mt + h]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[mt][nt][r] = rb[2 * mt + r / 2] + cb[nt][r % 2];
        }
      }
      if (16 * mt >= n) continue;   // uniform across the warp
      const int f0 = (pl * MAXK * W) / 4 + mt * KS * 32 + lane;
      const uint4* fh = reinterpret_cast<const uint4*>(sAh) + f0;
      const uint4* fl = reinterpret_cast<const uint4*>(sAl) + f0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (8 * nt < m) relation_tile(acc[mt][nt], fh, fl, rows[nt]);
      }
    }

    // target terms: su_j += Eu_j . ei (tu, by user slot), si_k += Ei_k .
    // eu (ti by column, or tis by item slot)
    float xu[NT][kComp], xi[NT][kComp];   // f32 rows (the f32 path's)
    float tu[NT] = {}, ti[NT][2] = {}, tis[NT] = {};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      unpack(xr[i], xu[i]);
      unpack(rows[i], xi[i]);
    }
    if (target_aware) {
      if constexpr (BF16) {   // exact bf16 products on the tensor cores
        const uint4* ef = sEuF + pl * 8 + q;   // [k-step][q]
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (16 * mt >= n) continue;
          float tt[4] = {0.f, 0.f, 0.f, 0.f};
          const uint4 x0 = xr[2 * mt].v, x1 = xr[2 * mt + 1].v;
          mma_bf16(tt, x0.x, x1.x, x0.y, x1.y, raw_ei.v.x, raw_ei.v.y);
          mma_bf16(tt, x0.z, x1.z, x0.w, x1.w, raw_ei.v.z, raw_ei.v.w);
          tu[2 * mt] = tt[0];
          tu[2 * mt + 1] = tt[2];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt >= m) continue;
          float st[4] = {0.f, 0.f, 0.f, 0.f};
          const uint4 e0 = ef[0], e1 = ef[4];
          mma_bf16(st, e0.x, e0.y, e0.z, e0.w, rows[nt].v.x, rows[nt].v.y);
          mma_bf16(st, e1.x, e1.y, e1.z, e1.w, rows[nt].v.z, rows[nt].v.w);
          ti[nt][0] = st[0];
          ti[nt][1] = st[1];
        }
      } else {   // f32: dots on the CUDA cores
        float ev[kComp], euv[kComp];
        unpack(raw_ei, ev);
        lds8(sEuv + pl * kPad + l0, euv);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          tu[i] = group_sum(dot8(xu[i], ev, 0.f));
          tis[i] = group_sum(dot8(xi[i], euv, 0.f));
        }
      }
    }

    // su: row maxima (over the quad); si: column maxima (across it) by a
    // transposing max over g, each then moved to the lane of its item row
    float su[NT], cm[2 * NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      su[i] = kNeg;
      cm[2 * i] = cm[2 * i + 1] = kNeg;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          su[2 * mt + r / 2] = fmaxf(su[2 * mt + r / 2], acc[mt][nt][r]);
          cm[2 * nt + r % 2] = fmaxf(cm[2 * nt + r % 2], acc[mt][nt][r]);
        }
      }
    }
    if constexpr (BF16) {
#pragma unroll
      for (int c = 0; c < 2 * NT; ++c) cm[c] += ti[c / 2][c % 2];
    }
    // lane (g, q) keeps column 8 nt + 2q + e: NT = 2: nt = g >> 2, e =
    // (g >> 1) & 1; NT = 4: nt = g >> 1, e = g & 1
    fold_max<NT>(cm, lane, 16);
    fold_max<NT / 2>(cm, lane, 8);
    if constexpr (NT == 4) {
      fold_max<1>(cm, lane, 4);
    } else {
      cm[0] = fmaxf(cm[0], __shfl_xor_sync(kFull, cm[0], 4));
    }
    float si[NT];
    bool uv[NT], iv[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      su[i] = fmaxf(su[i], __shfl_xor_sync(kFull, su[i], 1));
      su[i] = fmaxf(su[i], __shfl_xor_sync(kFull, su[i], 2));
      su[i] = (su[i] + tu[i]) * c2;
      // item row 8i + g: column nt = i, 2q' + e = g
      const int gs = NT == 4 ? 2 * i + (g & 1) : 4 * i + 2 * (g & 1);
      si[i] = __shfl_sync(kFull, cm[0], 4 * gs + (g >> 1));
      if constexpr (!BF16) si[i] += tis[i];
      si[i] *= c2;
      uv[i] = (ubits >> (8 * i + g)) & 1u;
      iv[i] = (bits >> (8 * i + g)) & 1u;
    }
    float eu_w[NT], ei_w[NT];
    const float inv_u =
        __fdividef(1.0f, fmaxf(softmax_weights<NT>(su, uv, eu_w), 1e-20f));
    const float inv_i =
        __fdividef(1.0f, fmaxf(softmax_weights<NT>(si, iv, ei_w), 1e-20f));
    if constexpr (BF16) {   // the weighted sums on the tensor cores
      uint4 xu4[NT], xi4[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        xu4[i] = xr[i].v;
        xi4[i] = rows[i].v;
      }
      float y[kComp];
      weighted_mma<NT>(eu_w, xu4, lane, y);
      if (g == 0) {
#pragma unroll
        for (int c = 0; c < kComp; ++c) y[c] *= inv_u;
        store8<VEC>(cu + bct * d, l0, d, y);
      }
      weighted_mma<NT>(ei_w, xi4, lane, y);
      if (g == 1) {
#pragma unroll
        for (int c = 0; c < kComp; ++c) y[c] *= inv_i;
        store8<VEC>(ci + bct * d, l0, d, y);
      }
    } else {                // f32: on the CUDA cores
      const float yu = weighted_fold<NT>(eu_w, xu, lane) * inv_u;
      const float yi = weighted_fold<NT>(ei_w, xi, lane) * inv_i;
      if (l0 + g < d) {
        cu[bct * d + l0 + g] = from_f32<T>(yu);
        ci[bct * d + l0 + g] = from_f32<T>(yi);
      }
    }
  };
  // two buffers in turn: each unit's loads are in flight while the warp
  // works on the one before
  Raw<T> rows_a[NT], rows_b[NT], ei_a, ei_b;
  int4 in_a = sUnit[u], in_b;
  load_items(in_a, rows_a, ei_a);
  while (true) {
    const bool more_a = u + nw < units;   // uniform across the warp
    if (more_a) {
      in_b = sUnit[u + nw];
      load_items(in_b, rows_b, ei_b);
    }
    unit(in_a, rows_a, ei_a);
    u += nw;
    if (!more_a) break;
    const bool more_b = u + nw < units;
    if (more_b) {
      in_a = sUnit[u + nw];
      load_items(in_a, rows_a, ei_a);
    }
    unit(in_b, rows_b, ei_b);
    u += nw;
    if (!more_b) break;
  }
}

// One block: b in [b0, b0 + nbb), candidates [c0, c0 + tile), every t.
// `c2` is 1/sqrt(d) * log2(e), which puts the scores in log2 units. EUW:
// EuW staged (always for the max pool); MAXK: the max pool's bound on n
// and m (0 for the others).
template <typename T, bool VEC, bool EUW, int POOL, int MAXK>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
cand_fwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                const uint8_t* __restrict__ mu, const uint8_t* __restrict__ mi,
                const float* __restrict__ Wr, const T* __restrict__ eu,
                const T* __restrict__ ei, T* __restrict__ cu,
                T* __restrict__ ci, int B, int C, int Tn, int n, int m, int d,
                int target_aware, float c2, int tile, int ntile, int nbb,
                int tchunk) {
  // Eu rows stay in T where every unit forms v; with EuW staged they are
  // read twice a unit and kept in f32, which saves the unpacking
  // (the max pool reads them once a unit, as the tensor cores take them)
  using S = typename std::conditional<EUW && POOL != kMax, float, T>::type;
  constexpr bool MAX = POOL == kMax;
  constexpr int W = kAWords<T>;
  extern __shared__ float4 smem4[];
  float* sWr = reinterpret_cast<float*>(smem4);  // [e][l] = Wr[e][l]
  float* sWrT = sWr + kPad * kPad;               // [e][l] = Wr[l][e]
  float* sW = sWrT + kPad * kPad;                // [pair][32] w * c2
  float* sMs = sW + (MAX ? 0 : tchunk * kPad);   // [pair][32] masked sums
  float* sEuv = sMs + (MAX ? 0 : tchunk * kPad); // [pair][32] eu (0 if not)
  float* sEuW = sEuv + tchunk * kPad;            // [pair][j][32] EuW * c2
  // max: [pair][k-step][q] eu as bf16 A rows (the fragments' order), and
  // [pair][MAXK rows * W words] EuW in A fragments, hi and lo
  unsigned* sEuF = reinterpret_cast<unsigned*>(
      sEuW + (EUW && !MAX ? tchunk * n * kPad : 0));
  unsigned* sAh = sEuF + (MAX ? tchunk * kPad : 0);
  unsigned* sAl = sAh + (MAX ? tchunk * MAXK * W : 0);
  S* sEu = reinterpret_cast<S*>(sAl + (MAX ? tchunk * MAXK * W : 0));
  // [unit] item-mask bits; max: {b * C + c - b0 * C - c0, t, pair, bits}
  unsigned* sUnitBits = reinterpret_cast<unsigned*>(sEu + tchunk * n * kPad);
  unsigned* sBits = sUnitBits + tchunk * tile * (MAX ? 4 : 1);   // [pair]
  uint8_t* sMaskB = reinterpret_cast<uint8_t*>(sBits + tchunk);  // [pair][j]

  const int tid = threadIdx.x, nth = blockDim.x;
  const long long b0 = (long long)(blockIdx.x / ntile) * nbb;
  const int c0 = (blockIdx.x % ntile) * tile;
  const int tc = min(tile, C - c0);
  const int np = (int)min((long long)nbb, B - b0) * Tn;   // the block's pairs
  const int lane = tid & 31, gw = lane >> 2, q = lane & 3, l0 = q * kComp;
  const int warp = tid >> 5, stride = (nth >> 5) * 8;

  for (int p0 = 0; p0 < np; p0 += tchunk) {
    const int tt = min(tchunk, np - p0);
    const long long gp0 = b0 * Tn + p0;   // the chunk's first b * Tn + t
    const int units = tc * tt;

    // --- A0 (before the barrier: the last chunk's units read none of
    // it): Wr (first chunk), each pair's eu and user-mask bytes
    if (p0 == 0) {
#pragma unroll 4
      for (int i = tid; i < kPad * kPad; i += nth) {
        const int e = i / kPad, l = i % kPad;
        const bool in = e < d && l < d;
        sWr[i] = in ? Wr[e * d + l] : 0.f;
        if (!EUW) sWrT[i] = in ? Wr[l * d + e] : 0.f;
      }
    }
#pragma unroll 2
    for (int i = tid; i < tt * kPad; i += nth) {
      const int l = i % kPad;
      const long long b = b0 + (p0 + i / kPad) / Tn;
      sEuv[i] = (target_aware && l < d) ? to_f32(eu[b * d + l]) : 0.f;
    }
    const uint8_t* mu_c = mu + gp0 * n;
#pragma unroll 4
    for (int i = tid; i < tt * n; i += nth) sMaskB[i] = mu_c[i] != 0;
    __syncthreads();

    // --- A: each unit's item-mask bit set, and the valid Eu rows, 8 (row,
    // 8-component part) slots a thread in flight
    for (int u = tid; u < units; u += nth) {
      const int pl = u / tc, bl = (p0 + pl) / Tn;
      const uint8_t* row =
          mi + (((b0 + bl) * C + c0 + u - pl * tc) * Tn + p0 + pl - bl * Tn) *
                   m;
      unsigned bits = 0;
#pragma unroll 4
      for (int k = 0; k < m; ++k) bits |= (row[k] ? 1u : 0u) << k;
      if (MAX) {   // b * C + c - b0 * C - c0, t, pair, bits
        reinterpret_cast<int4*>(sUnitBits)[u] = make_int4(
            bl * C + u - pl * tc, p0 + pl - bl * Tn, pl, bits);
      } else {
        sUnitBits[u] = bits;
      }
    }
    {
      const T* Eu_c = Eu + gp0 * n * d;
      const int slots = tt * n * kGroup;
      for (int s0 = tid; s0 < slots; s0 += 8 * nth) {
        Raw<T> raw[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int slot = s0 + i * nth, tj = slot >> 2;
          load_raw<VEC>(Eu_c + (long long)tj * d, (slot & 3) * kComp, d,
                        slot < slots && sMaskB[tj], raw[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int slot = s0 + i * nth;
          if (slot < slots) sts_conv(sEu + slot * kComp, raw[i]);
        }
      }
    }
    __syncthreads();

    // --- B: the masked sums (the mean's divided by the valid count) and
    // the mask bit sets of the user side
    for (int i = tid; i < (MAX ? 0 : tt * kPad); i += nth) {
      const int p = i / kPad, e = i % kPad;
      float s = 0.f;
      int cnt = 0;
      for (int j = 0; j < n; ++j) {
        s += to_f32(sEu[(p * n + j) * kPad + e]);
        if (POOL == kMean) cnt += sMaskB[p * n + j];
      }
      sMs[i] = POOL == kMean ? s * (1.0f / fmaxf((float)cnt, 1.f)) : s;
    }
    for (int p = tid; p < tt; p += nth) {
      unsigned bits = 0;
      for (int j = 0; j < n; ++j) bits |= (unsigned)sMaskB[p * n + j] << j;
      sBits[p] = bits;
    }
    __syncthreads();

    // --- C: w = (masked sum) @ Wr + eu, and EuW = Eu @ Wr, times c2
    for (int i = tid; i < (MAX ? 0 : tt * kPad); i += nth) {
      const int p = i / kPad, l = i % kPad;
      float w4[4] = {sEuv[i], 0.f, 0.f, 0.f};   // 4 chains, not one of d
      for (int e = 0; e < d; e += 4) {
        const float4 ms = *reinterpret_cast<const float4*>(sMs + p * kPad + e);
        w4[0] = fmaf(ms.x, sWr[e * kPad + l], w4[0]);
        w4[1] = fmaf(ms.y, sWr[(e + 1) * kPad + l], w4[1]);
        w4[2] = fmaf(ms.z, sWr[(e + 2) * kPad + l], w4[2]);
        w4[3] = fmaf(ms.w, sWr[(e + 3) * kPad + l], w4[3]);
      }
      sW[i] = ((w4[0] + w4[1]) + (w4[2] + w4[3])) * c2;
    }
    if constexpr (MAX && std::is_same<T, __nv_bfloat16>::value) {
      euw_mma<MAXK>(sWr, sEu, sAh, sAl, tt, n);
    } else if constexpr (MAX) {   // f32: the CUDA cores (3xTF32 tiles were
      // slower here), 4 components a thread, zeros past n
      for (int i = tid; i < tt * MAXK * (kPad / 4); i += nth) {
        const int l4 = (i % (kPad / 4)) * 4, pr = i / (kPad / 4);
        const int p = pr / MAXK, j = pr - p * MAXK, pj = p * n + j;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (l4 < d && j < n && sMaskB[pj]) {
          const S* x = sEu + pj * kPad;
          for (int e = 0; e < d; ++e) {
            const float xe = to_f32(x[e]);
            const float4 wr = *reinterpret_cast<const float4*>(
                sWr + e * kPad + l4);
            a[0] = fmaf(xe, wr.x, a[0]);
            a[1] = fmaf(xe, wr.y, a[1]);
            a[2] = fmaf(xe, wr.z, a[2]);
            a[3] = fmaf(xe, wr.w, a[3]);
          }
        }
        store_tf32(a, sAh + p * MAXK * W, sAl + p * MAXK * W, j, l4);
      }
    } else if (EUW) {   // the valid user rows, 4 components a thread
      for (int i = tid; i < tt * n * (kPad / 4); i += nth) {
        const int l4 = (i % (kPad / 4)) * 4, pj = i / (kPad / 4);
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (l4 < d && sMaskB[pj]) {
          const S* x = sEu + pj * kPad;
          for (int e = 0; e < d; ++e) {
            const float xe = to_f32(x[e]);
            const float4 wr = *reinterpret_cast<const float4*>(
                sWr + e * kPad + l4);
            a[0] = fmaf(xe, wr.x, a[0]);
            a[1] = fmaf(xe, wr.y, a[1]);
            a[2] = fmaf(xe, wr.z, a[2]);
            a[3] = fmaf(xe, wr.w, a[3]);
          }
        }
        *reinterpret_cast<float4*>(sEuW + pj * kPad + l4) =
            make_float4(a[0] * c2, a[1] * c2, a[2] * c2, a[3] * c2);
      }
    }
    if (MAX && sizeof(T) == 2) {   // eu as bf16 A rows: {lo, lo, hi, hi}
      for (int i = tid; i < tt * 8; i += nth) {   // words a k-step
        const int p = i >> 3, c = 8 * (i & 3) + 4 * ((i >> 2) & 1);
        const float* x = sEuv + p * kPad + c;
        const unsigned wl = bf16x2(x[0], x[1]), wh = bf16x2(x[2], x[3]);
        reinterpret_cast<uint4*>(sEuF)[i] = make_uint4(wl, wl, wh, wh);
      }
    }
    __syncthreads();

    if constexpr (MAX) {
      max_units<T, VEC, MAXK>(Ei, ei, cu, ci,
                              reinterpret_cast<const int4*>(sUnitBits), sBits,
                              sEuv, reinterpret_cast<const uint4*>(sEuF), sAh,
                              sAl, sEu, b0 * C + c0, Tn, units, n, m, d,
                              target_aware, c2);
      __syncthreads();   // the next chunk's A0 rewrites sEuv
    } else {
      // --- the units of this chunk, a group each; the loop is warp-uniform
      for (int ub = warp * 8; ub < units; ub += stride) {
        const int u = ub + gw;
        const bool act = u < units;
        // unit u: pair p0 + u / tc, candidate c0 + u % tc (candidate-fastest)
        const int pl = act ? u / tc : 0, cl = act ? u - pl * tc : 0;
        const int bl = (p0 + pl) / Tn, t = p0 + pl - bl * Tn;
        const long long bc = (b0 + bl) * C + c0 + cl;
        const long long bct = bc * Tn + t;
        const unsigned bits = act ? sUnitBits[u] : 0u;

        // every valid row's load of the first batch in flight, and ei's
        const T* Ei_u = Ei + bct * m * d;
        Raw<T> raw[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          load_raw<VEC>(Ei_u + (long long)r * d, l0, d,
                        r < m && ((bits >> r) & 1u), raw[r]);
        }
        Raw<T> raw_ei;
        load_raw<VEC>(ei + bc * d, l0, d, act && target_aware, raw_ei);

        // item side: si_k = Ei_k . w, ci = softmax-weighted sum of Ei_k
        float w[kComp];
        lds8(sW + pl * kPad + l0, w);
        float isum[kComp] = {};
        Softmax8 item;
        for (int k0 = 0; k0 < m; k0 += kRows) {
          if (k0 > 0) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int k = k0 + r;
              load_raw<VEC>(Ei_u + (long long)k * d, l0, d,
                            k < m && ((bits >> k) & 1u), raw[r]);
            }
          }
          float s[kRows];
          float bm = kNeg;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int k = k0 + r;
            float x[kComp];
            unpack(raw[r], x);
            s[r] = group_sum(dot8(x, w, 0.f));
#pragma unroll
            for (int i = 0; i < kComp; ++i) isum[i] += x[i];   // 0 if masked
            if (k < m && ((bits >> k) & 1u)) bm = fmaxf(bm, s[r]);
          }
          item.begin(bm);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int k = k0 + r;
            launder(raw[r]);
            float x[kComp];
            unpack(raw[r], x);
            item.add(s[r], x, k < m && ((bits >> k) & 1u));
          }
        }
        if (POOL == kMean) {   // the unit's item mean, not its sum
          const float inv = 1.0f / fmaxf((float)__popc(bits), 1.f);
#pragma unroll
          for (int i = 0; i < kComp; ++i) isum[i] *= inv;
        }
        float y[kComp];
        if (act) {
          item.result(y);
          store8<VEC>(ci + bct * d, l0, d, y);
        }

        // user side: ev = ei * c2 (EUW) or v * c2 = (isum @ Wr^T + ei) * c2
        float ev[kComp];
        unpack(raw_ei, ev);
        if (!EUW) {
          const int base = lane & ~3;
#pragma unroll
          for (int qq = 0; qq < kGroup; ++qq) {
            if (qq * kComp >= d) break;   // uniform across the warp
#pragma unroll
            for (int i = 0; i < kComp; ++i) {
              const float sv = __shfl_sync(kFull, isum[i], base + qq);
              float wt[kComp];
              lds8(sWrT + (qq * kComp + i) * kPad + l0, wt);
#pragma unroll
              for (int o = 0; o < kComp; ++o) ev[o] = fmaf(sv, wt[o], ev[o]);
            }
          }
        }
#pragma unroll
        for (int o = 0; o < kComp; ++o) ev[o] *= c2;
        // su_j = EuW_j . isum + Eu_j . ei (EUW) or Eu_j . v
        const unsigned ubits = sBits[pl];
        const S* eu_p = sEu + pl * n * kPad + l0;
        const float* euw_p = sEuW + pl * n * kPad + l0;
        Softmax8 user;
        for (int j0 = 0; j0 < n; j0 += kRows) {
          float s[kRows];
          float bm = kNeg;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int j = min(j0 + r, n - 1);
            Raw<S> rj;
            lds_raw(eu_p + j * kPad, rj);
            float yj[kComp];
            unpack(rj, yj);
            float sj;
            if (EUW) {
              float z[kComp];
              lds8(euw_p + j * kPad, z);
              sj = dot8(z, isum, 0.f);
              if (target_aware) sj = dot8(yj, ev, sj);
            } else {
              sj = dot8(yj, ev, 0.f);
            }
            s[r] = group_sum(sj);
            if (j0 + r < n && ((ubits >> j) & 1u)) bm = fmaxf(bm, s[r]);
          }
          user.begin(bm);
          const S* eu_q = launder_ptr(eu_p);   // read the rows again
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int j = min(j0 + r, n - 1);
            Raw<S> rj;
            lds_raw(eu_q + j * kPad, rj);
            float yj[kComp];
            unpack(rj, yj);
            user.add(s[r], yj, j0 + r < n && ((ubits >> j) & 1u));
          }
        }
        if (act) {
          user.result(y);
          store8<VEC>(cu + bct * d, l0, d, y);
        }
      }
    }
  }
}

template <typename T, bool VEC, int POOL>
int launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
           const float* Wr, const void* eu, const void* ei, void* cu,
           void* ci, int B, int C, int Tn, int n, int m, int d,
           int target_aware, cudaStream_t stream) {
  const Plan p = plan<T, POOL>(B, C, Tn, n, m);
  const long long blocks =
      (long long)((B + p.nbb - 1) / p.nbb) * p.ntile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float c2 = kLog2e / sqrtf((float)d);
  auto kern = cand_fwd_kernel<T, VEC, true, POOL, POOL == kMax ? 16 : 0>;
  if constexpr (POOL == kMax) {   // tiles that cover n and m
    if (n > 16 || m > 16) kern = cand_fwd_kernel<T, VEC, true, kMax, 32>;
  } else if (!p.euw) {
    kern = cand_fwd_kernel<T, VEC, false, POOL, 0>;
  }
  kern<<<(unsigned)blocks, p.threads, p.smem, stream>>>(
      (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi, Wr,
      (const T*)eu, (const T*)ei, (T*)cu, (T*)ci, B, C, Tn, n, m, d,
      target_aware, c2, p.tile, p.ntile, p.nbb, p.tchunk);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The forward with pool POOL, after the checks of the C entry points.
template <typename T, int POOL>
int dispatch(const void* Eu, const void* Ei, const void* mu, const void* mi,
             const float* Wr, const void* eu, const void* ei, void* cu,
             void* ci, int B, int C, int Tn, int n, int m, int d,
             int target_aware, cudaStream_t stream) {
  // the 16-byte path reads Eu, Ei and ei and writes cu and ci
  const bool vec = (d * (int)sizeof(T)) % 16 == 0 && aligned16(Eu) &&
                   aligned16(Ei) && aligned16(ei) && aligned16(cu) &&
                   aligned16(ci);
  return vec ? launch<T, true, POOL>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B,
                                     C, Tn, n, m, d, target_aware, stream)
             : launch<T, false, POOL>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B,
                                      C, Tn, n, m, d, target_aware, stream);
}

}  // namespace
