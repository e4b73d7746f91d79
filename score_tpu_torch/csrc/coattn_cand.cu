// Candidates-form co-attention forward, sum pool (SCoRe's cross-neighbour
// co-attention in the form serving computes).
//
// Replaces the forward of score_tpu/kernels/coattn_cand.py:cross_coattn_cand
// (_cand_fwd, body _cand_fwd_kernel over _fwd_common).
//
// Math, for each (b, c, t), with the Wr product reassociated onto the
// [d]-sized masked sums:
//   w    = (sum_j mu_j Eu_j) @ Wr            (+ eu_b       if target_aware)
//   v    = (sum_k mi_k Ei_ck) @ Wr^T         (+ ei_bc      if target_aware)
//   su_j = Eu_j . v / sqrt(d)     a = masked softmax of su over j (mask mu)
//   si_k = Ei_ck . w / sqrt(d)    b = masked softmax of si over k (mask mi)
//   cu   = sum_j a_j Eu_j         ci = sum_k b_k Ei_ck
// A row with no valid entry gives exact zeros, not NaN.
//
// Bound on the H100: bytes. Per (b, c, t) the kernel must read the valid
// rows of Ei (m*d values) and write 2*d outputs; the arithmetic, about
// 4*(n+m)*d + 2*d*d flops, is under 10 flops per byte at bf16, far below
// the card's ~295 flop/byte line. The first design (one warp per (b, t)
// and 8 candidates, lane l holding component l) ran at 7.8x that bound,
// held back by instruction issue and latency, not bytes: a row load moved
// 2 bytes a lane, every score was a 5-step shuffle butterfly, the d x d
// product v = isum @ Wr^T took 32 broadcast shuffles, all 32 lanes computed
// the same exponentials, and every warp redid the user side of its (b, t).
// This design:
//   * A group of 4 lanes owns one (b, c, t) unit; lane q holds components
//     [8q, 8q+8) of every d-vector (d <= 32). A row is one 16-byte load a
//     lane in bf16 (two in f32), a dot is 8 FMAs in the lane and a 2-step
//     shuffle in the group, and one warp instruction computes the
//     exponentials of 8 units' scores. The softmaxes go a batch of kRows
//     rows at a time: the batch's max first, then one exponential a row,
//     f32 throughout, in log2 units (1/sqrt(d) * log2(e) folded into w, EuW
//     and v).
//   * A block owns a tile of candidates of one b over all t, or, when one
//     tile holds all C, several b's. Per (b, t) pair it stages once, in
//     shared memory: the valid Eu rows, the user-mask bits, w (the masked
//     sum @ Wr, plus eu) and the block's units' item-mask bits. When the
//     tile holds at least n candidates it also stages EuW = Eu @ Wr, so
//     su_j = EuW_j . isum + Eu_j . ei needs no d x d product per candidate;
//     narrower tiles (training's C = 2, score's B = 1) form v per unit from
//     Wr^T in shared memory, 32 shuffles gathering isum over the group.
//   * Units go candidate-fastest, so a warp's 8 groups mostly share their
//     (b, t) and their shared-memory reads of the user side broadcast.
//   * The tile is taken from B and C so that at least 2 x 132 blocks run
//     where B * C allows (B = 1, C = 256 gives 256 blocks of one candidate
//     each), at most 64 candidates a block; the launch bounds hold 4 blocks
//     of 128 threads on an SM.
//   * Masks arrive as bytes and become bit sets; rows a mask excludes are
//     never read. The 16-byte path needs rows of a multiple of 16 bytes and
//     16-byte-aligned inputs; anything else (d = 7, an offset view) takes
//     the scalar path of the same kernel.
// ptxas (nvcc 12.9, sm_90a), registers of the 8 instances (T, 16-byte
// path, EuW staged): bf16 vector 128 and 124, f32 vector 121 and 117, f32
// scalar 120 and 128, none spilling; bf16 scalar (d*2 % 16 != 0 or an
// unaligned view) 128 with a 24- and a 16-byte spill frame.

#include <type_traits>

#include "coattn_common.cuh"

namespace {

constexpr int kGroup = 4;        // lanes a unit
constexpr int kComp = 8;         // components a lane (kGroup * kComp = 32)
constexpr int kPad = 32;         // shared-memory row width, in floats
constexpr int kMaxThreads = 128;
constexpr int kBlocksPerSm = 4;  // caps registers at 128 a thread
constexpr int kMaxTile = 64;     // candidates a block
constexpr int kMinBlocks = 2 * 132;
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

template <typename T>
Plan plan(int B, int C, int Tn, int n) {
  Plan p;
  const long long want = (kMinBlocks + B - 1) / B;     // tiles a b wanted
  long long nt = (C + kMaxTile - 1) / kMaxTile;
  if (want > nt) nt = want < C ? want : C;
  p.tile = (int)((C + nt - 1) / nt);
  p.ntile = (C + p.tile - 1) / p.tile;
  // EuW = Eu @ Wr once a (b, t) costs n d x d rows; v per unit costs one
  // such row a candidate: stage EuW once the tile holds n candidates
  p.euw = p.tile >= n;
  // a pair's Eu rows (in T), EuW rows, w, masked sum and eu (f32), its
  // units' item-mask bit sets, its user-mask bit set and mask bytes
  const int per_pair = n * kPad * (p.euw ? 8 : (int)sizeof(T))
                       + 3 * kPad * 4 + 4 * p.tile + 4 + n;
  const int fit = kChunkBytes / per_pair > 1 ? kChunkBytes / per_pair : 1;
  // small C: as many b's a block as keep kMinBlocks blocks, about
  // kUnitsPerBlock units and one chunk
  long long nbb = 1;
  if (p.ntile == 1) {
    nbb = B / kMinBlocks;
    const long long by_units = kUnitsPerBlock / ((long long)C * Tn);
    const long long by_smem = fit / Tn;
    if (by_units < nbb) nbb = by_units;
    if (by_smem < nbb) nbb = by_smem;
    if (nbb < 1) nbb = 1;
  }
  p.nbb = (int)nbb;
  const long long pairs = nbb * Tn;
  p.tchunk = (int)(pairs < fit ? pairs : fit);
  long long groups = ((long long)p.tile * p.tchunk + 7) / 8 * 8;
  if (groups > kMaxThreads / kGroup) groups = kMaxThreads / kGroup;
  p.threads = (int)groups * kGroup;
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

// One block: b in [b0, b0 + nbb), candidates [c0, c0 + tile), every t.
// `c2` is 1/sqrt(d) * log2(e), which puts the scores in log2 units.
template <typename T, bool VEC, bool EUW>
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
  using S = typename std::conditional<EUW, float, T>::type;
  extern __shared__ float4 smem4[];
  float* sWr = reinterpret_cast<float*>(smem4);  // [e][l] = Wr[e][l]
  float* sWrT = sWr + kPad * kPad;               // [e][l] = Wr[l][e]
  float* sW = sWrT + kPad * kPad;                // [pair][32] w * c2
  float* sMs = sW + tchunk * kPad;               // [pair][32] masked sums
  float* sEuv = sMs + tchunk * kPad;             // [pair][32] eu (0 if not)
  float* sEuW = sEuv + tchunk * kPad;            // [pair][j][32] EuW * c2
  S* sEu = reinterpret_cast<S*>(sEuW + (EUW ? tchunk * n * kPad : 0));
  unsigned* sUnitBits = reinterpret_cast<unsigned*>(sEu + tchunk * n * kPad);
  unsigned* sBits = sUnitBits + tchunk * tile;   // [pair] user-mask bits
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
      sUnitBits[u] = bits;
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

    // --- B: the masked sums and the mask bit sets of the user side
    for (int i = tid; i < tt * kPad; i += nth) {
      const int p = i / kPad, e = i % kPad;
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += to_f32(sEu[(p * n + j) * kPad + e]);
      sMs[i] = s;
    }
    for (int p = tid; p < tt; p += nth) {
      unsigned bits = 0;
      for (int j = 0; j < n; ++j) bits |= (unsigned)sMaskB[p * n + j] << j;
      sBits[p] = bits;
    }
    __syncthreads();

    // --- C: w = (masked sum) @ Wr + eu, and EuW = Eu @ Wr, times c2
    for (int i = tid; i < tt * kPad; i += nth) {
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
    if (EUW) {   // the valid user rows, 4 components a thread
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
    __syncthreads();

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

template <typename T, bool VEC>
int launch(const void* Eu, const void* Ei, const void* mu, const void* mi,
           const float* Wr, const void* eu, const void* ei, void* cu,
           void* ci, int B, int C, int Tn, int n, int m, int d,
           int target_aware, cudaStream_t stream) {
  const Plan p = plan<T>(B, C, Tn, n);
  const long long blocks =
      (long long)((B + p.nbb - 1) / p.nbb) * p.ntile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float c2 = kLog2e / sqrtf((float)d);
  auto kern = p.euw ? cand_fwd_kernel<T, VEC, true>
                    : cand_fwd_kernel<T, VEC, false>;
  kern<<<(unsigned)blocks, p.threads, p.smem, stream>>>(
      (const T*)Eu, (const T*)Ei, (const uint8_t*)mu, (const uint8_t*)mi, Wr,
      (const T*)eu, (const T*)ei, (T*)cu, (T*)ci, B, C, Tn, n, m, d,
      target_aware, c2, p.tile, p.ntile, p.nbb, p.tchunk);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T>
int dispatch(const void* Eu, const void* Ei, const void* mu, const void* mi,
             const float* Wr, const void* eu, const void* ei, void* cu,
             void* ci, int B, int C, int Tn, int n, int m, int d,
             int target_aware, cudaStream_t stream) {
  // the 16-byte path reads Eu, Ei and ei and writes cu and ci
  const bool vec = (d * (int)sizeof(T)) % 16 == 0 && aligned16(Eu) &&
                   aligned16(Ei) && aligned16(ei) && aligned16(cu) &&
                   aligned16(ci);
  return vec ? launch<T, true>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn,
                               n, m, d, target_aware, stream)
             : launch<T, false>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B, C, Tn,
                                n, m, d, target_aware, stream);
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
  return dtype == 0 ? dispatch<float>(Eu, Ei, mu, mi, Wr, eu, ei, cu, ci, B,
                                       C, Tn, n, m, d, target_aware, s)
                    : dispatch<__nv_bfloat16>(Eu, Ei, mu, mi, Wr, eu, ei, cu,
                                              ci, B, C, Tn, n, m, d,
                                              target_aware, s);
}

extern "C" const char* coattn_cand_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
