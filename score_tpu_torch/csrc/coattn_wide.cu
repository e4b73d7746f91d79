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
// Bound on the H100: bytes, for every pool (the valid rows read once, the
// outputs written once). The max pool's EuW and relation matrix, 2*n*d*d
// a (b, t) and 2*n*m*d a unit, run on the tensor cores in two bf16 passes
// at 989 TFLOP/s or three TF32 passes at 495, under the bytes' time at
// every shape here; the rest is under 10 f32 operations a byte.
//
// The forward runs on the tensor cores. One product carries all three
// pools: with EuW = Eu Wr, the relation matrix M = EuW Ei^T holds the sum
// pool's scores as its row and column sums (EuW_j . Es = sum_k M_jk and
// Ei_k . Em Wr = sum_j M_jk, masked rows being zeros; the mean divides by
// the counts) and the max pool's as its row and column maxima (invalid
// entries biased by -1e9, 0 where a side has no valid row); the target
// terms are added after. f32 inputs take M for the max pool only: their
// sum and mean scores are those dots themselves on the CUDA cores, si_k
// = Ei_k . (Em Wr + eu) with Em Wr as EuW's column sums, formed once an
// item into eu's staged row, and su_j = EuW_j . Es + Eu_j . ei at the
// unit's end, Es summed over its tiles: (n + m) d f32 FMAs a unit in
// place of M's 3 n m d TF32 products and their operand splits.
//   * A warp owns a work item: a (b, t) and a run of at most 32 of its
//     candidates, and at least two where C allows (units go
//     candidate-fastest), on a persistent grid of the resident blocks,
//     about 8 items a resident warp. It forms EuW once an item on mma.sync
//     tiles, its user rows as A (16-row m-tiles, n <= 64) and Wr as B from
//     fragments each block stages once: bf16 m16n8k16 with Eu exact and Wr
//     split hi + lo; f32 m16n8k8 with both split into tf32 hi + lo
//     (3xTF32). EuW lands in the warp's shared memory as the relation
//     matrix's A fragments (bf16: split hi + lo; f32: as f32 values, split
//     where used).
//   * A unit's item rows come in tiles of 16 (two 8-row n-tiles; m > 16
//     takes up to 4 tiles, the item softmax then running over them).
//     Lane (g, q) holds rows g and g + 8 of a tile, components 32 r + 8 q
//     .. + 7 of each 32-component chunk r (d <= 32 R, R = 1, 2 or 4): one
//     16-byte shared load a row and chunk is the B operand as it stands,
//     the d index permuted within the lane's 8 components as EuW's A
//     fragments permute it. Rows past m or d are zeros. Row sums or
//     maxima of M reduce within the quad (2 shuffles), column ones by a
//     transposing fold across g (6 shuffles a tile for both slots).
//   * bf16: the target terms (eu and ei exact) and both softmax-weighted
//     sums run on the tensor cores too, the weights split hi + lo and the
//     rows transposed by movmatrix (coattn_cand.cuh's max pool does the
//     same at d <= 32). f32: on the CUDA cores, the lane's rows summed
//     and then folded across g.
//   * Rows reach shared memory by cp.async through a ring of two stages,
//     the next tile in flight while the warp works on the current one;
//     masked rows are zero-filled and never read; the user rows once an
//     item, in the input dtype. The 16-byte path needs rows of a multiple
//     of 16 bytes and aligned inputs; odd d and offset views, which have
//     no speed target, take one scalar instance of the same kernel (R = 4,
//     four m-tiles) for each dtype and pool kind.
// Against the first form's limits: its idle lanes and serial per-row dots
// are mma tiles in which every lane takes part; its shared-memory operand
// traffic for the d x d products is gone (EuW and M on the tensor cores,
// operands as 16-byte fragment loads); its unoverlapped staging is a
// cp.async ring; and at d = 64 bf16 an SM holds 16 warps (128 registers,
// 12 KB of shared memory each), where time tracks resident warps.
// Shared memory: the block's Wr fragments, 4 KB R^2, and a warp's EuW
// fragments (2 KB a 16-row m-tile and chunk: bf16 hi and lo, f32
// values), its user rows and eu, a ring of two 17-row stages (pitch
// 32 R + 4 f32 or 32 R (+ 32 at even R) bf16 elements) and min(C, 32) m
// mask bytes.
// Split error: a bf16 hi + lo split leaves |x - hi - lo| <= 2^-16 |x|, so
// M is within 2^-15 sum_l (|EuW_jl Ei_kl| + sum_e |Eu_je Wr_el Ei_kl|) of
// its exact value; 3xTF32 within 2^-20 of the same sums (before the f32
// sums' own rounding), and f32 EuW within 2^-20 sum_e |Eu_je Wr_el|, which
// the f32 sum and mean carry into their dots; tests/test_torch_wide.py
// checks both at d = 128, n = m = 64.
// ptxas (sm_90a, chip_smoke.py's [device] phase prints them): registers a
// thread (+ spill-store bytes) of each 16-byte instance, for R = 1, 2, 4,
// each at kMT = 1 and 4, then the scalar instance:
//   bf16 sum, mean  84, 127; 128+6, 166; 143, 168+62; scalar 168+238
//   bf16 max        98, 125; 127, 166; 141, 168+34; scalar 168+90
//   f32 sum, mean   104, 124; 168+12, 162; 186, 215; scalar 241
//   f32 max         100, 123; 136, 154; 168+26, 163; scalar 168
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
#include <type_traits>

#include "coattn_cand.cuh"

namespace {

enum WidePool { kWSum = 0, kWMean = 1, kWMax = 2 };

constexpr int kWideMaxD = 128;
constexpr int kWideMaxRows = 64;
constexpr int kSmemLimit = 232448;          // bytes a block may use, sm_90
constexpr int kFwdItemsPerWarp = 8;         // work items a resident warp

// --- the forward -----------------------------------------------------------

// Warps a forward block at most, as registers allow: bf16 16 at R = 1, and
// at R = 2 with one user m-tile (128 registers a thread), else 12 (168);
// f32, whose 3xTF32 products need more registers, 12, and 6 at R = 4.
// Shared memory may hold fewer.
template <typename T>
__host__ __device__ constexpr int fwd_max_warps(int R, int kMT) {
  return sizeof(T) == 2 ? (R == 1 || (R == 2 && kMT == 1) ? 16 : 12)
                        : (R == 4 ? 6 : 12);
}

// k-steps of a tensor-core product a 32-component chunk: bf16 m16n8k16 2,
// tf32 m16n8k8 4.
template <typename T> constexpr int kKPC = 4;
template <> constexpr int kKPC<__nv_bfloat16> = 2;

// Row pitch of the staged user rows, in elements of T: 32 R components,
// padded so that a quarter warp's 16-byte reads of rows g and g + 1 (bf16:
// one read a lane; f32: two) fall on distinct banks.
template <typename T, int R>
__host__ __device__ constexpr int fwd_pitch() {
  return sizeof(T) == 2 ? 32 * R + (R % 2 == 0 ? 32 : 0) : 32 * R + 4;
}

constexpr int kMaxChunk = 32;    // candidates a work item
constexpr int kStages = 2;       // ring stages: one tile in flight ahead

// Rows of a ring stage: a tile's item rows (16, or m where m < 16) and
// the unit's ei.
__host__ __device__ inline int stage_rows(int m) {
  return (m < 16 ? m : 16) + 1;
}

// Bytes of shared memory: the block's Wr fragments, and a warp's buffers
// for MT user m-tiles, S ring stages, m item rows a unit and C candidates
// (EuW's A fragments, hi and lo; the user rows and eu; the ring; the
// item-mask bytes of a run, at most kMaxChunk units).
template <int R>
__host__ __device__ constexpr int fwd_wr_bytes() { return 4096 * R * R; }
template <typename T, int R>
__host__ __device__ inline int fwd_warp_bytes(int MT, int S, int m, int C) {
  return (sizeof(T) == 2 ? 2 : 1) * MT * R * kKPC<T> * 32 * 16 +
         (16 * MT + 1 + S * stage_rows(m)) * fwd_pitch<T, R>() *
             (int)sizeof(T) +
         ((C < kMaxChunk ? C : kMaxChunk) * m + 15) / 16 * 16;
}

// The low (first) and high (second) element of a bf16x2 word, in f32.
__device__ __forceinline__ float bf16_first(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_second(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
// The bf16 lo parts of a pair whose hi parts are the word `hi`.
__device__ __forceinline__ unsigned bf16x2_lo(float a, float b, unsigned hi) {
  return bf16x2(a - bf16_first(hi), b - bf16_second(hi));
}

template <typename T, int R>
__device__ __forceinline__ float dot_chunks(const Raw<T> (&x)[R],
                                            const Raw<T> (&y)[R]) {
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float a[kComp], b[kComp];
    unpack(x[r], a);
    unpack(y[r], b);
    s = dot8(a, b, s);
  }
  return s;
}

// Sum over the 8 lanes of each q (lanes q, q + 4, ..., q + 28).
__device__ __forceinline__ float g_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}
__device__ __forceinline__ float g_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 4));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 8));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 16));
}

// Wr as the B operand of EuW = Eu Wr, in fragment order [n-tile nt < 4 R]
// [k-step][lane (g, q)], column 8 nt + g, rows of the lane's k-step as the
// relation matrix's A and B permute them (see wide_fwd_kernel): bf16, one
// uint4 {hi b0, hi b1, lo b0, lo b1} of k-step (r, s)'s rows 32 r + 8 q +
// 4 s + 0..3; f32, one float2 {b0, b1} of rows 32 r + 8 q + 2 s + {0, 1}
// (split into tf32 hi + lo where used). Zeros past d. Both 4096 R^2 bytes.
template <typename T, int R>
__device__ __forceinline__ void stage_wr_frags(void* dst,
                                               const float* __restrict__ Wr,
                                               int d) {
  constexpr int KS = R * kKPC<T>, kTotal = 4 * R * KS * 32, kB = 4;
  auto wr = [&](int k, int e) {
    return k < d && e < d ? __ldg(Wr + k * d + e) : 0.f;
  };
  // kB entries a thread at a time, all their loads issued first
  for (int i0 = threadIdx.x; i0 < kTotal; i0 += kB * blockDim.x) {
    float x[kB][4];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int i = i0 + u * blockDim.x;
      const int lane = i & 31, ks = (i >> 5) % KS, nt = (i >> 5) / KS;
      const int e = 8 * nt + (lane >> 2), q = lane & 3;
      const int k0 = sizeof(T) == 2 ? 32 * (ks >> 1) + 8 * q + 4 * (ks & 1)
                                    : 32 * (ks >> 2) + 8 * q + 2 * (ks & 3);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[u][c] = i < kTotal && (sizeof(T) == 2 || c < 2) ? wr(k0 + c, e)
                                                          : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= kTotal) break;
      if constexpr (sizeof(T) == 2) {
        const unsigned h0 = bf16x2(x[u][0], x[u][1]);
        const unsigned h1 = bf16x2(x[u][2], x[u][3]);
        reinterpret_cast<uint4*>(dst)[i] =
            make_uint4(h0, h1, bf16x2_lo(x[u][0], x[u][1], h0),
                       bf16x2_lo(x[u][2], x[u][3], h1));
      } else {
        reinterpret_cast<float2*>(dst)[i] = make_float2(x[u][0], x[u][1]);
      }
    }
  }
}

// 16 bytes from global to shared memory, asynchronously; `bytes` < 16
// zero-fills the rest (0: the source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of the thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Components l0 .. l0 + 7 of a row into shared memory at dst (zeros past d;
// all zeros where !ok, and the row is then not read): by cp.async where
// `vec`, else by plain loads and a store.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* row, int l0,
                                           int d, bool ok, bool vec) {
  if (vec) {
    cp_async16(dst, row + l0, ok && l0 < d ? 16 : 0);
    if constexpr (sizeof(T) == 4) {
      cp_async16(dst + 4, row + l0 + 4, ok && l0 + 4 < d ? 16 : 0);
    }
  } else {
    Raw<T> r;
    load_raw<false>(row, l0, d, ok, r);
    sts_conv(dst, r);
  }
}

// EuW = Eu Wr for the staged user rows, on the tensor cores, into the
// relation matrix's A fragments [m-tile][k-step][lane] (uint4 each). bf16:
// Eu is exact, Wr hi + lo, 2 products; each D pair (row j, components e,
// e + 1) is one word, split into hi (sAh) and lo (sAl). f32: Eu and Wr
// split into tf32 hi + lo, 3 products (hi hi, hi lo, lo hi); each D value
// is one word of sAh as it is (relation2 splits it where used).
template <typename T, int R>
__device__ __forceinline__ void euw_frags(const T* __restrict__ sEu,
                                          const void* __restrict__ sWrF,
                                          uint4* sAh, uint4* sAl, int MT,
                                          int lane) {
  // n-tiles of EuW's columns in groups of NW (the accumulators of 4 R
  // n-tiles at R = 4 would spill)
  constexpr int P = fwd_pitch<T, R>(), KS = R * kKPC<T>;
  constexpr int NW = R < 2 ? 4 * R : 8;
  const int g = lane >> 2, q = lane & 3;
  unsigned* ah = reinterpret_cast<unsigned*>(sAh);
  unsigned* al = reinterpret_cast<unsigned*>(sAl);
  for (int mg = 0; mg < MT * (4 * R / NW); ++mg) {
    const int mt = mg / (4 * R / NW), nt0 = (mg % (4 * R / NW)) * NW;
    float acc[NW][4];
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    }
    const T* r0 = sEu + (16 * mt + g) * P + 8 * q;
    const T* r1 = r0 + 8 * P;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Raw<T> x0, x1;
      lds_raw(r0 + 32 * r, x0);
      lds_raw(r1 + 32 * r, x1);
      if constexpr (sizeof(T) == 2) {
        const uint4 u0 = x0.v, u1 = x1.v;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const unsigned a0 = s ? u0.z : u0.x, a1 = s ? u1.z : u1.x;
          const unsigned a2 = s ? u0.w : u0.y, a3 = s ? u1.w : u1.y;
          const uint4* b = reinterpret_cast<const uint4*>(sWrF) +
                           (nt0 * KS + 2 * r + s) * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < NW; ++nt) {
            const uint4 w = b[nt * KS * 32];
            mma_bf16(acc[nt], a0, a1, a2, a3, w.x, w.y);
            mma_bf16(acc[nt], a0, a1, a2, a3, w.z, w.w);
          }
        }
      } else {
        float f0[kComp], f1[kComp];
        unpack(x0, f0);
        unpack(x1, f1);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float av[4] = {f0[2 * s], f1[2 * s], f0[2 * s + 1],
                               f1[2 * s + 1]};
          unsigned ahi[4], alo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ahi[i] = to_tf32(av[i]);
            alo[i] = to_tf32(av[i] - __uint_as_float(ahi[i]));
          }
          const float2* b = reinterpret_cast<const float2*>(sWrF) +
                            (nt0 * KS + 4 * r + s) * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < NW; ++nt) {
            const float2 w = b[nt * KS * 32];
            const unsigned bh0 = to_tf32(w.x), bh1 = to_tf32(w.y);
            const unsigned bl0 = to_tf32(w.x - __uint_as_float(bh0));
            const unsigned bl1 = to_tf32(w.y - __uint_as_float(bh1));
            mma_tf32(acc[nt], ahi[0], ahi[1], ahi[2], ahi[3], bh0, bh1);
            mma_tf32(acc[nt], ahi[0], ahi[1], ahi[2], ahi[3], bl0, bl1);
            mma_tf32(acc[nt], alo[0], alo[1], alo[2], alo[3], bh0, bh1);
          }
        }
      }
    }
    // D of n-tile nt: rows 16 mt + g (+ 8), columns e = 8 nt + 2 q (+ 1),
    // which lane (g, nt % 4) of k-step (nt / 4, q / 2) (bf16) or
    // (nt / 4, q) (tf32) holds
#pragma unroll
    for (int nw = 0; nw < NW; ++nw) {
      const int nt = nt0 + nw;
      const int l2 = 4 * g + (nt & 3);
      if constexpr (sizeof(T) == 2) {
        const int ks = 2 * (nt >> 2) + (q >> 1);
        const int f = ((mt * KS + ks) * 32 + l2) * 4 + 2 * (q & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned hi = bf16x2(acc[nw][2 * h], acc[nw][2 * h + 1]);
          ah[f + h] = hi;
          al[f + h] = bf16x2_lo(acc[nw][2 * h], acc[nw][2 * h + 1], hi);
        }
      } else {
        const int ks = 4 * (nt >> 2) + q;
        const int f = ((mt * KS + ks) * 32 + l2) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // (row h, column + b): word 2b + h
          ah[f + 2 * (i & 1) + (i >> 1)] = __float_as_uint(acc[nw][i]);
        }
      }
    }
  }
}

// acc_h += EuW_hi x the item rows' chunk, acc_l += EuW_lo x it (two
// accumulators, so that the two chains of products run side by side):
// bf16 items are exact (EuW staged as hi and lo fragments); f32 items and
// EuW (staged as its f32 values) are split into tf32 hi + lo, and acc_h
// takes hi * hi + hi * lo, acc_l lo * hi (3xTF32).
__device__ __forceinline__ void relation2(float acc_h[4], float acc_l[4],
                                          const uint4* fh, const uint4* fl,
                                          const Raw<__nv_bfloat16>& b) {
  mma_tile(acc_h, fh, b.v);
  mma_tile(acc_l, fl, b.v);
}
__device__ __forceinline__ void relation2(float acc_h[4], float acc_l[4],
                                          const uint4* fa, const uint4*,
                                          const Raw<float>& b) {
  float x[kComp];
  unpack(b, x);
  unsigned h[kComp], l[kComp];
#pragma unroll
  for (int i = 0; i < kComp; ++i) {
    h[i] = to_tf32(x[i]);
    l[i] = to_tf32(x[i] - __uint_as_float(h[i]));
  }
  // f32 EuW is staged once, as its values: split here into tf32 hi + lo
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint4 a = fa[32 * s];
    const float av[4] = {__uint_as_float(a.x), __uint_as_float(a.y),
                         __uint_as_float(a.z), __uint_as_float(a.w)};
    unsigned ah[4], al[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      ah[w] = to_tf32(av[w]);
      al[w] = to_tf32(av[w] - __uint_as_float(ah[w]));
    }
    mma_tf32(acc_h, ah[0], ah[1], ah[2], ah[3], h[2 * s], h[2 * s + 1]);
    mma_tf32(acc_h, ah[0], ah[1], ah[2], ah[3], l[2 * s], l[2 * s + 1]);
    mma_tf32(acc_l, al[0], al[1], al[2], al[3], h[2 * s], h[2 * s + 1]);
  }
}

// acc += the 16 rows of A, each the same bf16 vector v (one chunk of the
// lane's 8 components), times B = the chunk of the rows in b: acc[0],
// acc[1] = v . row 2q, v . row 2q + 1 (exact products, f32 sums).
__device__ __forceinline__ void vec_rows(float acc[4], const uint4& v,
                                         const uint4& b) {
  mma_bf16(acc, v.x, v.x, v.y, v.y, b.x, b.y);
  mma_bf16(acc, v.z, v.z, v.w, v.w, b.z, b.w);
}

// acc += A = rows r0 (g) and r1 (g + 8), one bf16 chunk each, times B =
// the same vector v in every column: acc[0] = r0 . v, acc[2] = r1 . v.
__device__ __forceinline__ void rows_vec(float acc[4], const uint4& r0,
                                         const uint4& r1, const uint4& v) {
  mma_bf16(acc, r0.x, r1.x, r0.y, r1.y, v.x, v.y);
  mma_bf16(acc, r0.z, r1.z, r0.w, r1.w, v.z, v.w);
}

// The A operand of a softmax-weighted sum of 16 rows (slot i's row 8 i +
// g weighs e[i], replicated over q), as weighted_mma forms it: rows 0-7
// the weights' bf16 hi parts, rows 8-15 their lo parts.
__device__ __forceinline__ void weights_a(const float e[2], int lane,
                                          unsigned a[4]) {
  const int q = lane & 3;
  const float w0 = __shfl_sync(kFull, e[0], 8 * q);
  const float w1 = __shfl_sync(kFull, e[0], 8 * q + 4);
  const float w2 = __shfl_sync(kFull, e[1], 8 * q);
  const float w3 = __shfl_sync(kFull, e[1], 8 * q + 4);
  a[0] = bf16x2(w0, w1);
  a[1] = bf16x2_lo(w0, w1, a[0]);
  a[2] = bf16x2(w2, w3);
  a[3] = bf16x2_lo(w2, w3, a[2]);
}

// y += the 16 rows (slot i: x_i, the lane's bf16 chunk of row 8 i + g)
// weighted by A = weights_a's, on the tensor cores (weighted_mma's
// product): components [8 q, 8 q + 8) of the chunk, in every lane.
__device__ __forceinline__ void weighted_rows(const unsigned a[4],
                                              const uint4& x0,
                                              const uint4& x1,
                                              float y[kComp]) {
  const unsigned u0[4] = {x0.x, x0.y, x0.z, x0.w};
  const unsigned u1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(acc, a[0], a[1], a[2], a[3], movmatrix_t(u0[v]),
             movmatrix_t(u1[v]));
    y[2 * v] += acc[0] + acc[2];   // hi rows + lo rows
    y[2 * v + 1] += acc[1] + acc[3];
  }
}

// Where a work item lies: its (b, t), its first candidate and how many.
struct FwdItem {
  long long b, bt;
  int t, c0, nc;
};

// A warp owns a work item, a (b, t) and a run of at most kMaxChunk of its
// candidates, and takes the run's units one after another, an item tile
// of 16 rows at a time (two mma n-tiles, slots i = 0, 1: rows 16 tt + 8 i
// + g), the tiles of the run streaming through a ring of S = kStages
// stages in shared memory by cp.async, the next in flight while the warp
// works on one (a stage holds min(m, 16) rows; the rest of the tile reads
// as zeros). MT = the user m-tiles (n <= 16 MT <= 16 kMT). kVec: 16-byte
// loads and stores. `c2` is 1/sqrt(d) * log2(e): scores in log2 units.
template <typename T, bool kMaxPool, int R, int kMT, bool kVec>
__global__ void __launch_bounds__(fwd_max_warps<T>(R, kMT) * 32)
wide_fwd_kernel(const T* __restrict__ Eu, const T* __restrict__ Ei,
                const uint8_t* __restrict__ mu,
                const uint8_t* __restrict__ mi, const float* __restrict__ Wr,
                const T* __restrict__ eu, const T* __restrict__ ei,
                T* __restrict__ cu, T* __restrict__ ci, int C, int Tn, int n,
                int m, int d, int target_aware, int mean, float c2,
                int chunk, int chunks, long long items) {
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int P = fwd_pitch<T, R>(), KPC = kKPC<T>, KS = R * KPC;
  constexpr float kInit = kMaxPool ? kNeg : 0.f;
  // f32 sum and mean: no relation matrix; the scores are dots on the CUDA
  // cores, si_k = Ei_k . (Em Wr + eu) and su_j = EuW_j . Es + Eu_j . ei
  constexpr bool kDot = !kBF16 && !kMaxPool;
  extern __shared__ uint4 fwd_smem[];
  const int MT = (n + 15) >> 4;
  constexpr int S = kStages;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  constexpr bool v16 = kVec;   // 16-byte loads and stores
  const void* sWrF = fwd_smem;
  // the warp's buffers: EuW's A fragments (hi, lo), the user rows and eu
  // (row 16 MT), the ring of item tiles (kr rows, and with a unit's last
  // tile its ei as row kr), the run's item-mask bytes
  uint4* sAh = reinterpret_cast<uint4*>(
      reinterpret_cast<unsigned char*>(fwd_smem) + fwd_wr_bytes<R>() +
      warp * fwd_warp_bytes<T, R>(MT, S, m, C));
  uint4* sAl = sAh + (kBF16 ? MT * KS * 32 : 0);   // f32: unused
  T* sEu = reinterpret_cast<T*>(sAl + MT * KS * 32);
  T* ring = sEu + (16 * MT + 1) * P;
  const int kr = min(m, 16), stage = (kr + 1) * P;   // a stage's rows, size
  uint8_t* sMk = reinterpret_cast<uint8_t*>(ring + S * stage);
  stage_wr_frags<T, R>(fwd_smem, Wr, d);
  __syncthreads();
  // item tiles a unit: one in the kMT = 1 instances (n, m <= 16), whose
  // item softmax then needs no running max
  constexpr bool kOne = kMT == 1;
  const int nti = kOne ? 1 : (m + 15) >> 4;

  auto place = [&](long long it) {
    FwdItem p;
    p.bt = it / chunks;
    p.c0 = (int)(it - p.bt * chunks) * chunk;
    p.nc = min(C, p.c0 + chunk) - p.c0;
    p.b = p.bt / Tn;
    p.t = (int)(p.bt - p.b * Tn);
    return p;
  };
  // the item's mask bytes: user rows lane and lane + 32; item rows of its
  // units (unit u's row k at byte u m + k) lane and lane + 32, where they
  // fit two a lane (pre), loaded while the warp works on the item before
  uint8_t pmu[2] = {0, 0}, pmi[2] = {0, 0};
  bool pre = false;
  auto load_masks = [&](const FwdItem& p) {
    pre = p.nc * m <= 64;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      pmu[h] = j < n ? mu[p.bt * n + j] : 0;
      const int u = j / m;
      pmi[h] = pre && j < p.nc * m
                   ? mi[((p.b * C + p.c0 + u) * Tn + p.t) * m + j - u * m]
                   : 0;
    }
  };
  const long long stride = (long long)gridDim.x * warps;
  long long item = (long long)blockIdx.x * warps + warp;
  if (item < items) load_masks(place(item));

  for (; item < items; item += stride) {
    const FwdItem p = place(item);
    const long long b = p.b;
    const int c0 = p.c0, nc = p.nc;
    // unit u's place: bc = b * C + c0 + u, bct = bc * Tn + t; its item
    // rows, ei and outputs from the item's first unit's, in strides
    const long long bct0 = (b * C + c0) * Tn + p.t;
    auto unit_bct = [&](int u) { return bct0 + (long long)u * Tn; };
    const T* Ei_it = Ei + bct0 * m * d;
    const T* ei_it = ei + (b * C + c0) * d;
    const int ustride = Tn * m * d;

    __syncwarp();   // the last item's reads of the warp's buffers are done
    const unsigned long long ubits =
        (unsigned long long)__ballot_sync(kFull, pmu[0] != 0) |
        (unsigned long long)__ballot_sync(kFull, pmu[1] != 0) << 32;
    if (pre) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (lane + 32 * h < nc * m) sMk[lane + 32 * h] = pmi[h];
      }
    } else {
      for (int i = lane; i < nc * m; i += 32) {
        const int u = i / m;
        sMk[i] = mi[unit_bct(u) * m + i - u * m];
      }
    }
    // the user rows (masked ones and rows n .. 16 MT - 1 zeros) and eu
    {
      const T* Eu_bt = Eu + p.bt * n * d;
      const int total = (16 * MT + 1) * 4 * R;
      for (int i = lane; i < total; i += 32) {
        const int j = i / (4 * R), c = i - j * 4 * R;
        const bool user = j < 16 * MT;
        const bool ok = user ? j < n && ((ubits >> j) & 1ull)
                             : target_aware != 0;
        copy_chunk(sEu + j * P + 8 * c, user ? Eu_bt + (long long)j * d
                                             : eu + b * d,
                   8 * c, d, ok, v16);
      }
    }
    cp_commit();
    __syncwarp();   // sMk
    // the next tile to issue: unit iu, tile itt, ring stage ist
    int iu = 0, itt = 0, ist = 0;
    auto issue_next = [&]() {
      if (iu < nc) {
        T* dst = ring + ist * stage;
        const T* rows = Ei_it + (long long)iu * ustride;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (8 * i + g >= kr) break;
          const int k = 16 * itt + 8 * i + g;
          const bool ok = k < m && sMk[iu * m + k] != 0;
          const T* row = rows + k * d;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            copy_chunk(dst + (8 * i + g) * P + 32 * r + 8 * q, row,
                       32 * r + 8 * q, d, ok, v16);
          }
        }
        if (itt == nti - 1 && g == 0) {   // lanes (0, q): the unit's ei
          const T* row = ei_it + iu * d;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            copy_chunk(dst + kr * P + 32 * r + 8 * q, row, 32 * r + 8 * q,
                       d, target_aware != 0, v16);
          }
        }
      }
      cp_commit();
      ist = ist + 1 == S ? 0 : ist + 1;
      if (++itt == nti) {
        itt = 0;
        ++iu;
      }
    };
    issue_next();
    if (item + stride < items) load_masks(place(item + stride));
    cp_async_wait<1>();   // the user rows
    __syncwarp();
    euw_frags<T, R>(sEu, sWrF, sAh, sAl, MT, lane);
    __syncwarp();
    const float inv_u =
        mean ? 1.f / fmaxf((float)__popcll(ubits), 1.f) : 1.f;
    const T* sev = sEu + 16 * MT * P + 8 * q;   // the lane's chunks of eu
    if constexpr (kDot) {   // eu's row becomes Em Wr (/ the count) + eu:
      // EuW's column sums (its masked rows are zeros), folded across g
      float w[R][kComp];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < kComp; ++c) w[r][c] = 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= MT) break;
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {   // words: (row, component) (g,
            const uint4 a = sAh[(mt * KS + r * KPC + s) * 32 + lane];
            w[r][2 * s] += __uint_as_float(a.x) + __uint_as_float(a.y);
            w[r][2 * s + 1] += __uint_as_float(a.z) + __uint_as_float(a.w);
          }   // 2 s), (g + 8, 2 s), (g, 2 s + 1), (g + 8, 2 s + 1)
        }
      }
      T* ev = sEu + 16 * MT * P;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fold<4>(w[r], lane, 16);
        fold<2>(w[r], lane, 8);
        fold<1>(w[r], lane, 4);
        const int l = 32 * r + 8 * q + g;   // the component lane (g, q) holds
        ev[l] = from_f32<T>(fmaf(w[r][0], inv_u, to_f32(ev[l])));
      }
      __syncwarp();
    }

    // the unit's state: its item-mask bits and ei, the user rows'
    // reductions of M over the columns so far (rows 16 mt + 8 h + g, the
    // lane's columns), and the item side's running softmax (max, sum, and
    // weighted rows: bf16, components 32 r + 8 q + c of the sum in every
    // lane; f32, the lane's rows and components)
    unsigned long long ibits = 0;
    float su_part[kMT][2], imx = kNeg, isum = 0.f, iacc[R][kComp];
    float es[R][kComp];   // kDot: the sum of the lane's item rows so far
    for (int u = 0, tt = 0, st = 0; u < nc;) {
      cp_async_wait<0>();   // the tile has landed
      __syncwarp();     // ... for every lane; the stage before it is free
      const T* sx = ring + st * stage;
      // slot i's rows (rows past a short stage: zeros); bf16 holds both
      // slots' in registers, f32 reads a slot's where it is used
      auto load_x = [&](int i, Raw<T> (&xi)[R]) {
        const bool in = 8 * i + g < kr;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (in) {
            lds_raw(sx + (8 * i + g) * P + 32 * r + 8 * q, xi[r]);
          } else {
            load_raw<false>(sx, 0, 0, false, xi[r]);
          }
        }
      };
      Raw<T> x[2][R];
      if constexpr (kBF16) {
        load_x(0, x[0]);
        load_x(1, x[1]);
      }
      if (tt == 0) {   // the unit's first tile
        const uint8_t* mk = sMk + u * m;
        ibits =
            (unsigned long long)__ballot_sync(kFull, lane < m && mk[lane]) |
            (unsigned long long)__ballot_sync(kFull,
                                              lane + 32 < m && mk[lane + 32])
                << 32;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          su_part[mt][0] = su_part[mt][1] = kInit;
        }
        imx = kNeg;
        isum = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < kComp; ++c) iacc[r][c] = es[r][c] = 0.f;
        }   // (in the kOne instances the first tile's sums replace these)
      }
      issue_next();

      // M = EuW Ei^T on the tile's 16 columns (+ the max pool's biases: 0
      // on a valid row and column, kNeg elsewhere); lane (g, q) holds rows
      // 16 mt + g (+ 8), columns 8 i + 2 q (+ 1) of slot i
      const unsigned tb = (unsigned)(ibits >> (16 * tt)) & 0xffffu;
      float cv[4] = {kInit, kInit, kInit, kInit};   // [slot][column parity]
#pragma unroll
      for (int mt = 0; mt < (kDot ? 0 : kMT); ++mt) {
        if (mt >= MT) break;   // uniform across the warp
        float ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            al[i][v] = 0.f;
            ah[i][v] = 0.f;
            if constexpr (kMaxPool) {
              const int j = 16 * mt + 8 * (v >> 1) + g;
              ah[i][v] = (((ubits >> j) & 1ull) ? 0.f : kNeg) +
                         (((tb >> (8 * i + 2 * q + (v & 1))) & 1u) ? 0.f
                                                                   : kNeg);
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int f0 = (mt * KS + r * KPC) * 32 + lane;
            if constexpr (kBF16) {
              relation2(ah[i], al[i], sAh + f0, sAl + f0, x[i][r]);
            } else {
              Raw<T> xi[R];
              load_x(i, xi);
              relation2(ah[i], al[i], sAh + f0, sAl + f0, xi[r]);
            }
          }
        }
        // the rows' reductions so far, and the columns' over these rows
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float a0 = ah[i][2 * h] + al[i][2 * h];
            const float a1 = ah[i][2 * h + 1] + al[i][2 * h + 1];
            if constexpr (kMaxPool) {
              su_part[mt][h] = fmaxf(su_part[mt][h], fmaxf(a0, a1));
              cv[2 * i] = fmaxf(cv[2 * i], a0);
              cv[2 * i + 1] = fmaxf(cv[2 * i + 1], a1);
            } else {
              su_part[mt][h] += a0 + a1;
              cv[2 * i] += a0;
              cv[2 * i + 1] += a1;
            }
          }
        }
      }
      // the columns across the rows of all lanes: the transposing steps
      // leave column 8 ((g >> 2) & 1) + 2 q + ((g >> 1) & 1) in lane (g, q)
      if constexpr (kMaxPool) {
        fold_max<2>(cv, lane, 16);
        fold_max<1>(cv, lane, 8);
        cv[0] = fmaxf(cv[0], __shfl_xor_sync(kFull, cv[0], 4));
        if (ubits == 0) cv[0] = 0.f;   // no valid user row: the maxima are 0
      } else if constexpr (!kDot) {
        fold<2>(cv, lane, 16);
        fold<1>(cv, lane, 8);
        cv[0] = (cv[0] + __shfl_xor_sync(kFull, cv[0], 4)) * inv_u;
      }
      if constexpr (kBF16) {   // + eu . Ei_k: exact products, tensor cores
        if (target_aware) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < R; ++r) {
            Raw<T> ev;
            lds_raw(sev + 32 * r, ev);
            vec_rows(t0, ev.v, x[0][r].v);
            vec_rows(t1, ev.v, x[1][r].v);
          }
          const float ta = (g & 2) ? t0[1] : t0[0];
          const float tc = (g & 2) ? t1[1] : t1[0];
          cv[0] += (g & 4) ? tc : ta;
        }
      }
      // si of item row 16 tt + 8 i + g (column 8 i + g), the item softmax
      // online over the unit's tiles
      float s[2], tmax = kNeg;
      bool valid[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[i] = kDot ? 0.f
                    : __shfl_sync(kFull, cv[0],
                                  16 * i + 8 * (g & 1) + (g >> 1));
        if constexpr (!kBF16) {   // + eu . Ei_k on the CUDA cores (kDot:
          if (kDot || target_aware) {   // the whole score, eu's row Em Wr + eu
            Raw<T> ev[R];
#pragma unroll
            for (int r = 0; r < R; ++r) lds_raw(sev + 32 * r, ev[r]);
            Raw<T> xi[R];
            asm volatile("" ::: "memory");   // read again, not held
            load_x(i, xi);
            float tdot = dot_chunks<T, R>(xi, ev);
            tdot += __shfl_xor_sync(kFull, tdot, 1);
            s[i] += tdot + __shfl_xor_sync(kFull, tdot, 2);
          }
        }
        s[i] *= c2;
        valid[i] = (tb >> (8 * i + g)) & 1u;
        if (valid[i]) tmax = fmaxf(tmax, s[i]);
      }
      const float nm = kOne ? g_max(tmax) : fmaxf(imx, g_max(tmax));
      const float rs = kOne ? 0.f : fast_exp2(imx - nm);
      imx = nm;
      float e[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) e[i] = valid[i] ? fast_exp2(s[i] - nm) : 0.f;
      isum = isum * rs + e[0] + e[1];
      unsigned wa[4];
      if constexpr (kBF16) weights_a(e, lane, wa);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float y[kComp];
#pragma unroll
        for (int c = 0; c < kComp; ++c) y[c] = kOne ? 0.f : iacc[r][c] * rs;
        if constexpr (kBF16) {   // the weighted sum on the tensor cores
          weighted_rows(wa, x[0][r].v, x[1][r].v, y);
        } else {   // f32: the rows read again (fewer registers held)
          asm volatile("" ::: "memory");   // not the values loaded before
          Raw<T> r0, r1;
          load_raw<false>(sx, 0, 0, false, r0);
          load_raw<false>(sx, 0, 0, false, r1);
          if (g < kr) lds_raw(sx + g * P + 32 * r + 8 * q, r0);
          if (8 + g < kr) lds_raw(sx + (8 + g) * P + 32 * r + 8 * q, r1);
          float x0[kComp], x1[kComp];
          unpack(r0, x0);
          unpack(r1, x1);
#pragma unroll
          for (int c = 0; c < kComp; ++c) {
            y[c] = fmaf(e[1], x1[c], fmaf(e[0], x0[c], y[c]));
            if constexpr (kDot) es[r][c] += x0[c] + x1[c];
          }
        }
#pragma unroll
        for (int c = 0; c < kComp; ++c) iacc[r][c] = y[c];
      }
      st = st + 1 == S ? 0 : st + 1;
      if (++tt < nti) continue;

      // --- the unit's end: ci, then the user side and cu (its ei came
      // with this tile)
      const long long bct = unit_bct(u);
      Raw<T> eiv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) lds_raw(sx + kr * P + 32 * r + 8 * q, eiv[r]);
      const float inv_i = 1.f / fmaxf(g_sum(isum), 1e-20f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (kBF16) {
          if (g == 0) {
#pragma unroll
            for (int c = 0; c < kComp; ++c) iacc[r][c] *= inv_i;
            if (v16) {
              store8<true>(ci + bct * d, 32 * r + 8 * q, d, iacc[r]);
            } else {
              store8<false>(ci + bct * d, 32 * r + 8 * q, d, iacc[r]);
            }
          }
        } else {
          fold<4>(iacc[r], lane, 16);
          fold<2>(iacc[r], lane, 8);
          fold<1>(iacc[r], lane, 4);
          const int l = 32 * r + 8 * q + g;   // the component lane (g, q) holds
          if (l < d) ci[bct * d + l] = from_f32<T>(iacc[r][0] * inv_i);
        }
      }
      const float inv_cnt =
          mean ? 1.f / fmaxf((float)__popcll(ibits), 1.f) : 1.f;
      if constexpr (kDot) {   // su_j's part: EuW_j . Es, the lane's components
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < kComp; ++c) {
            es[r][c] += __shfl_xor_sync(kFull, es[r][c], 4);
            es[r][c] += __shfl_xor_sync(kFull, es[r][c], 8);
            es[r][c] += __shfl_xor_sync(kFull, es[r][c], 16);
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          su_part[mt][0] = su_part[mt][1] = 0.f;
          if (mt >= MT) continue;
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int s = 0; s < 4; ++s) {   // the words as above
              const uint4 a = sAh[(mt * KS + r * KPC + s) * 32 + lane];
              su_part[mt][0] +=
                  __uint_as_float(a.x) * es[r][2 * s] +
                  __uint_as_float(a.z) * es[r][2 * s + 1];
              su_part[mt][1] +=
                  __uint_as_float(a.y) * es[r][2 * s] +
                  __uint_as_float(a.w) * es[r][2 * s + 1];
            }
          }
        }
      }
      float su[2 * kMT], mx = kNeg;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float tu[4] = {0.f, 0.f, 0.f, 0.f};   // Eu_j . ei, bf16
        if constexpr (kBF16) {
          if (target_aware && mt < MT) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              Raw<T> r0, r1;
              lds_raw(sEu + (16 * mt + g) * P + 32 * r + 8 * q, r0);
              lds_raw(sEu + (16 * mt + 8 + g) * P + 32 * r + 8 * q, r1);
              rows_vec(tu, r0.v, r1.v, eiv[r].v);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          su[2 * mt + h] = kNeg;
          if (mt >= MT) continue;
          float v = su_part[mt][h];
          if constexpr (kMaxPool) {
            v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
            v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
            if (ibits == 0) v = 0.f;   // no valid item row: the maxima are 0
          } else {
            v += __shfl_xor_sync(kFull, v, 1);
            v = (v + __shfl_xor_sync(kFull, v, 2)) * inv_cnt;
          }
          const int j = 16 * mt + 8 * h + g;
          if constexpr (kBF16) {
            v += tu[2 * h];
          } else if (target_aware) {   // Eu_j . ei on the CUDA cores
            Raw<T> xj[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              lds_raw(sEu + j * P + 32 * r + 8 * q, xj[r]);
            }
            float tdot = dot_chunks<T, R>(xj, eiv);
            tdot += __shfl_xor_sync(kFull, tdot, 1);
            v += tdot + __shfl_xor_sync(kFull, tdot, 2);
          }
          su[2 * mt + h] = v * c2;
          if ((ubits >> j) & 1ull) mx = fmaxf(mx, su[2 * mt + h]);
        }
      }
      mx = g_max(mx);
      float w[2 * kMT], usum = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * kMT; ++i) {
        const int j = 8 * i + g;
        w[i] = i < 2 * MT && ((ubits >> j) & 1ull) ? fast_exp2(su[i] - mx)
                                                   : 0.f;
        usum += w[i];
      }
      const float inv_s = 1.f / fmaxf(g_sum(usum), 1e-20f);
      unsigned ua[kMT][4];   // each m-tile's weights as A (bf16)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= MT) break;
        const float wm[2] = {w[2 * mt], w[2 * mt + 1]};
        if constexpr (kBF16) weights_a(wm, lane, ua[mt]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float y[kComp];
        if constexpr (kBF16) {   // the weighted sum on the tensor cores,
#pragma unroll                   // an m-tile of rows at a time
          for (int c = 0; c < kComp; ++c) y[c] = 0.f;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            if (mt >= MT) break;
            Raw<T> x0, x1;
            lds_raw(sEu + (16 * mt + g) * P + 32 * r + 8 * q, x0);
            lds_raw(sEu + (16 * mt + 8 + g) * P + 32 * r + 8 * q, x1);
            weighted_rows(ua[mt], x0.v, x1.v, y);
          }
          if (g == 0) {
#pragma unroll
            for (int c = 0; c < kComp; ++c) y[c] *= inv_s;
            if (v16) {
              store8<true>(cu + bct * d, 32 * r + 8 * q, d, y);
            } else {
              store8<false>(cu + bct * d, 32 * r + 8 * q, d, y);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < kComp; ++c) y[c] = 0.f;
#pragma unroll
          for (int i = 0; i < 2 * kMT; ++i) {
            if (i >= 2 * MT) break;
            Raw<T> xj;
            lds_raw(sEu + (8 * i + g) * P + 32 * r + 8 * q, xj);
            float xv[kComp];
            unpack(xj, xv);
#pragma unroll
            for (int c = 0; c < kComp; ++c) y[c] = fmaf(w[i], xv[c], y[c]);
          }
          fold<4>(y, lane, 16);
          fold<2>(y, lane, 8);
          fold<1>(y, lane, 4);
          const int l = 32 * r + 8 * q + g;
          if (l < d) cu[bct * d + l] = from_f32<T>(y[0] * inv_s);
        }
      }
      tt = 0;
      ++u;
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

// The forward's launch: the warps a block (as many as shared memory holds
// next to the block's Wr fragments, at most fwd_max_warps), the resident
// blocks, and work items of a (b, t) and a run of `chunk` <= kMaxChunk
// candidates, split so that each resident warp has about kFwdItemsPerWarp
// items, with at least two candidates an item where C allows.
template <typename T, bool kMaxPool, int R, int kMT, bool kVec>
int fwd_launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
               const float* Wr, const void* eu, const void* ei, void* cu,
               void* ci, int B, int C, int Tn, int n, int m, int d,
               int target_aware, int mean, cudaStream_t stream) {
  auto kernel = wide_fwd_kernel<T, kMaxPool, R, kMT, kVec>;
  const int MT = (n + 15) / 16;
  const long long bt = (long long)B * Tn;
  int warps = (kSmemLimit - fwd_wr_bytes<R>()) /
              fwd_warp_bytes<T, R>(MT, kStages, m, C);
  if (warps > fwd_max_warps<T>(R, kMT)) warps = fwd_max_warps<T>(R, kMT);
  if (warps > bt * C) warps = (int)(bt * C);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem =
      fwd_wr_bytes<R>() + warps * fwd_warp_bytes<T, R>(MT, kStages, m, C);
  const long long resident = grid_for(kernel, warps * 32, smem, 1LL << 40);
  long long chunks = (resident * warps * kFwdItemsPerWarp + bt - 1) / bt;
  if (chunks < (C + kMaxChunk - 1) / kMaxChunk) {
    chunks = (C + kMaxChunk - 1) / kMaxChunk;
  }
  // at least two units an item where C allows: EuW, formed once an item,
  // then serves both (on an H100, 1.13-1.36x faster than one at n = m =
  // 40, C = 2)
  if (chunks > (C + 1) / 2) chunks = (C + 1) / 2;
  const int chunk = (int)((C + chunks - 1) / chunks);
  chunks = (C + chunk - 1) / chunk;
  const long long items = bt * chunks;
  const long long want = (items + warps - 1) / warps;
  const int blocks = (int)(want < resident ? want : resident);
  kernel<<<blocks, warps * 32, smem, stream>>>(
      (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi, Wr,
      (const T*)eu, (const T*)ei, (T*)cu, (T*)ci, C, Tn, n, m, d,
      target_aware, mean, kLog2e / sqrtf((float)d), chunk, (int)chunks,
      items);
  return (int)cudaGetLastError();
}

// The instance for d (R: 32-component chunks a row), n and m (one user
// m-tile and one item tile a unit, or up to 4 each), with 16-byte loads;
// odd d and offset views, which have no speed target, take the one
// instance with scalar loads that covers every shape (R = 4, kMT = 4).
template <typename T, bool kMaxPool>
int fwd_width(const void* Eu, const void* Ei, const void* mu, const void* mi,
              const float* Wr, const void* eu, const void* ei, void* cu,
              void* ci, int B, int C, int Tn, int n, int m, int d,
              int target_aware, int mean, int vec, cudaStream_t s) {
#define WIDE_FWD(RR, MM, VEC)                                                \
  fwd_launch<T, kMaxPool, RR, MM, VEC>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci,   \
                                       B, C, Tn, n, m, d, target_aware,      \
                                       mean, s)
  if (!vec) return WIDE_FWD(4, 4, false);
  if (n <= 16 && m <= 16) {
    return d <= 32 ? WIDE_FWD(1, 1, true) : d <= 64 ? WIDE_FWD(2, 1, true)
                                                    : WIDE_FWD(4, 1, true);
  }
  return d <= 32 ? WIDE_FWD(1, 4, true) : d <= 64 ? WIDE_FWD(2, 4, true)
                                                  : WIDE_FWD(4, 4, true);
#undef WIDE_FWD
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
  // the 16-byte loads read Eu, Ei, eu and ei; cu and ci are written a
  // component a lane
  const int es = dtype == 0 ? 4 : 2;
  const int vec = (d * es) % 16 == 0 && aligned16(Eu) && aligned16(Ei) &&
                  aligned16(eu) && aligned16(ei);
  const int mean = pool == kWMean;
  cudaStream_t s = (cudaStream_t)stream;
#define WIDE_FWD(T, MAX)                                                     \
  fwd_width<T, MAX>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn, n, m, d,   \
                    target_aware, mean, vec, s)
  if (dtype == 0) {
    return pool == kWMax ? WIDE_FWD(float, true) : WIDE_FWD(float, false);
  }
  return pool == kWMax ? WIDE_FWD(__nv_bfloat16, true)
                       : WIDE_FWD(__nv_bfloat16, false);
#undef WIDE_FWD
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
