// Grouped row scatter-add: table = 0, then table[ids_s[i], :] += src_s[i, :]
// for every segment s (up to kMaxSegs of them, one row width W), into an f32
// [V, W] table, or from bf16 sources into a bf16 table. The backward of the
// row gather (gather.cu): the gradient of a table from the gradients of all
// of a step's lookups into it, so a table costs one host call a step however
// many times the step reads it.
//
// Replaces the transpose of score_tpu/kernels/gather.py:gather_rows_pallas
// (and of the jnp.take of the JAX package's lookups), which the TPU runs as
// XLA's own scatter-add: the Pallas kernel has no backward of its own.
//
// Bound on the H100: bytes. Each source row is read once and added into
// its table row, and the table is written once; there is no other
// arithmetic. Contention is not what limits it: a training batch's ids
// repeat little (chip_smoke.py's [scatter] counts the distinct ids of a
// real batch), so the adds need no aggregation.
// The design:
//   * the table is zeroed by cudaMemsetAsync on the caller's stream, and
//     one launch then covers every segment: segment s owns a range of
//     blocks in proportion to its vectors (at least one), of a grid of at
//     most kBlocksPerSm a multiprocessor, each block looping over its
//     segment's vectors;
//   * consecutive threads take consecutive VEC-float vectors of a
//     segment's flat source (VEC = 4 where W and every base pointer allow,
//     else 2 or 1), so a warp reads one contiguous span; a thread loads
//     one vector a pass and, only where it is not zero, its row's id (an
//     occupancy-sized grid with several loads a lane in flight, as the
//     gather has, was no faster on the H100: the reductions in L2, not
//     the loads, set the time);
//   * each vector goes into the table with one vector atomicAdd (float4
//     and float2 atomics into global memory are native on sm_90; the
//     result is unused, so it compiles to a reduction in L2);
//   * a vector of zeros is skipped. Masked neighbour slots carry id 0 and
//     a gradient of exact zeros, so the pad row, about half of a batch's
//     ids, takes almost no adds. Skipping x + 0 changes no sum (x + (-0)
//     == x, and 0 + (-0) == +0 as index_add_ gives);
//   * 32-bit offsets where every one fits, and a shift for the row of a
//     vector where the vectors a row are a power of two.
// The order of the adds to one row is not fixed, so float sums differ from
// the plain version's in the last bits; integer-valued sources are exact.
//
// The bf16 form (bf16 tables and their bf16 gradients) sums in f32 and
// rounds once: the sources' bf16 vectors are widened to f32 and added by the
// same vector atomics into an f32 workspace [V, W], which one more pass
// rounds to nearest even into the bf16 table. Its result is the exact sum
// rounded once, up to f32's order effects, and the same every run but for
// those. bf16x2 atomics would round at every add, in an order that changes
// from run to run. (The reference's XLA scatter-add on a bf16 table rounds
// at every add, in id order: a deliberate divergence, more accurate.)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 4;
constexpr int kBlocksPerSm = 32;   // the grid's cap, a multiprocessor

__device__ __forceinline__ bool nonzero(float x) { return x != 0.f; }
__device__ __forceinline__ bool nonzero(float2 x) {
  return x.x != 0.f || x.y != 0.f;
}
__device__ __forceinline__ bool nonzero(float4 x) {
  return x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f;
}
// bf16 sources are loaded as their bits: 1, 2 or 4 elements in an unsigned
// short, unsigned int or uint2, element 0 in the low half; +-0 has no bit
// but the sign set
__device__ __forceinline__ bool nonzero(unsigned short x) {
  return (x & 0x7fffu) != 0;
}
__device__ __forceinline__ bool nonzero(unsigned int x) {
  return (x & 0x7fff7fffu) != 0;
}
__device__ __forceinline__ bool nonzero(uint2 x) {
  return ((x.x | x.y) & 0x7fff7fffu) != 0;
}

// a source vector in f32, the accumulator's type: f32 as it is, bf16 exactly
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float2 widen(float2 x) { return x; }
__device__ __forceinline__ float4 widen(float4 x) { return x; }
__device__ __forceinline__ float lo_bf16(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float widen(unsigned short x) {
  return lo_bf16(x);
}
__device__ __forceinline__ float2 widen(unsigned int x) {
  return make_float2(lo_bf16(x), hi_bf16(x));
}
__device__ __forceinline__ float4 widen(uint2 x) {
  return make_float4(lo_bf16(x.x), hi_bf16(x.x), lo_bf16(x.y), hi_bf16(x.y));
}

struct Segments {
  const void* src[kMaxSegs];
  const int32_t* ids[kMaxSegs];
  long long vecs[kMaxSegs];            // vectors of the segment's source
  int first_block[kMaxSegs + 1];       // segment s: [first_block[s], [s+1])
};

// Load: a source vector as loaded; Vec: the same elements in f32, the
// table's (or the workspace's) vector
template <typename Load, typename Vec, typename Index>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const Segments seg, Vec* __restrict__ table, int vpr,
                   int vpr_shift) {
  // the block's segment, picked with constant indices only: a parameter
  // array indexed by a variable is first copied to each thread's local
  // memory (120 bytes a thread, more time than the adds at these sizes)
  const int b = blockIdx.x;
  const bool s1 = b >= seg.first_block[1], s2 = b >= seg.first_block[2],
             s3 = b >= seg.first_block[3];
  const Load* __restrict__ src = reinterpret_cast<const Load*>(
      s3 ? seg.src[3] : s2 ? seg.src[2] : s1 ? seg.src[1] : seg.src[0]);
  const int32_t* __restrict__ ids =
      s3 ? seg.ids[3] : s2 ? seg.ids[2] : s1 ? seg.ids[1] : seg.ids[0];
  const Index total = (Index)(s3 ? seg.vecs[3] : s2 ? seg.vecs[2]
                              : s1 ? seg.vecs[1] : seg.vecs[0]);
  const int first = s3 ? seg.first_block[3] : s2 ? seg.first_block[2]
                    : s1 ? seg.first_block[1] : seg.first_block[0];
  const int end = s3 ? seg.first_block[4] : s2 ? seg.first_block[3]
                  : s1 ? seg.first_block[2] : seg.first_block[1];
  const Index stride = (Index)(end - first) * kThreads;
  for (Index g = (Index)(b - first) * kThreads + threadIdx.x; g < total;
       g += stride) {
    const Load x = __ldg(src + g);
    if (!nonzero(x)) continue;
    const Index row = vpr_shift >= 0 ? g >> vpr_shift : g / vpr;
    atomicAdd(table + (Index)__ldg(ids + row) * vpr + (g - row * vpr),
              widen(x));
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

// The bf16 form's last pass: the f32 workspace rounded to nearest even
// into the bf16 table, 4 elements a thread for the first n4 groups of 4
// (both buffers aligned for it), one for the rest
__global__ void __launch_bounds__(kThreads)
scatter_add_round_kernel(const float* __restrict__ ws,
                         __nv_bfloat16* __restrict__ out, long long n,
                         long long n4) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(ws) + i);
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    reinterpret_cast<uint2*>(out)[i] = make_uint2(
        *reinterpret_cast<const unsigned int*>(&a),
        *reinterpret_cast<const unsigned int*>(&b));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    out[i] = __float2bfloat16_rn(__ldg(ws + i));
}

template <typename Load, typename Vec, typename Index>
void launch(Segments seg, int n_segs, float* table, int vpr,
            cudaStream_t stream) {
  const long long cap = (long long)kBlocksPerSm * num_sms();
  long long all = 0;
  for (int s = 0; s < n_segs; ++s) all += seg.vecs[s];
  // each segment's share of the grid, at least one block, and no more than
  // one a kThreads vectors
  int blocks = 0;
  for (int s = 0; s < n_segs; ++s) {
    seg.first_block[s] = blocks;
    long long b = (cap * seg.vecs[s] + all - 1) / all;
    const long long most = (seg.vecs[s] + kThreads - 1) / kThreads;
    if (b > most) b = most;
    blocks += (int)(b > 0 ? b : 1);
  }
  for (int s = n_segs; s <= kMaxSegs; ++s) seg.first_block[s] = blocks;
  const int shift = (vpr & (vpr - 1)) == 0 ? __builtin_ctz(vpr) : -1;
  scatter_add_kernel<Load, Vec, Index><<<blocks, kThreads, 0, stream>>>(
      seg, (Vec*)table, vpr, shift);
}

// Up to 4 segments into the f32 `table` [num_rows, W], zeroed first on the
// same stream: f32 sources (kBf16 false) or bf16 ones, widened as they are
// added. The vector is the widest of 4, 2 and 1 elements that W and every
// base pointer allow.
template <bool kBf16>
int scatter_segments(const void* const srcs[kMaxSegs],
                     const int32_t* const idss[kMaxSegs],
                     const long long ns[kMaxSegs], float* table,
                     long long num_rows, long long W, cudaStream_t s) {
  if (W <= 0 || num_rows < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(table, 0, (size_t)(num_rows * W * 4), s);
  if (err != cudaSuccess) return (int)err;
  Segments seg = {};
  int n_segs = 0;
  // the table's alignment and, in bytes of a source element, the sources'
  uintptr_t a = (uintptr_t)table | (uintptr_t)(W * 4);
  uintptr_t b = (uintptr_t)(W * (kBf16 ? 2 : 4));
  for (int i = 0; i < kMaxSegs; ++i) {
    if (ns[i] <= 0) continue;
    seg.src[n_segs] = srcs[i];
    seg.ids[n_segs] = idss[i];
    seg.vecs[n_segs] = ns[i];   // rows for now; vectors below
    b |= (uintptr_t)srcs[i];
    ++n_segs;
  }
  if (n_segs == 0) return (int)cudaGetLastError();
  int vec;
  if (kBf16) {
    vec = (a & 15u) == 0 && (b & 7u) == 0 ? 4
        : (a & 7u) == 0 && (b & 3u) == 0 ? 2 : 1;
  } else {
    a |= b;
    vec = (a & 15u) == 0 ? 4 : (a & 7u) == 0 ? 2 : 1;
  }
  const long long vpr = W / vec;
  if (vpr > (1LL << 30)) return (int)cudaErrorInvalidValue;
  long long most = num_rows * vpr;
  for (int i = 0; i < n_segs; ++i) {
    seg.vecs[i] *= vpr;
    if (seg.vecs[i] > most) most = seg.vecs[i];
  }
  // 32-bit offsets where every one, and a loop's step past the end, fits
  const bool narrow = most < (1LL << 29);
  const int v = (int)vpr;
#define SCATTER(LOAD, VEC)                                          \
  narrow ? launch<LOAD, VEC, int>(seg, n_segs, table, v, s)         \
         : launch<LOAD, VEC, long long>(seg, n_segs, table, v, s)
  if (kBf16) {
    switch (vec) {
      case 4: SCATTER(uint2, float4); break;
      case 2: SCATTER(unsigned int, float2); break;
      default: SCATTER(unsigned short, float); break;
    }
  } else {
    switch (vec) {
      case 4: SCATTER(float4, float4); break;
      case 2: SCATTER(float2, float2); break;
      default: SCATTER(float, float); break;
    }
  }
#undef SCATTER
  return (int)cudaGetLastError();
}

}  // namespace

// Up to 4 segments (src_s [n_s, W] f32, ids_s [n_s] int32 in [0,
// num_rows)) of one W into table [num_rows, W] f32, zeroed first on the
// same stream; a segment with n_s <= 0 is skipped.
extern "C" int scatter_add_segments(
    const float* src0, const int32_t* ids0, long long n0, const float* src1,
    const int32_t* ids1, long long n1, const float* src2, const int32_t* ids2,
    long long n2, const float* src3, const int32_t* ids3, long long n3,
    float* table, long long num_rows, long long W, void* stream) {
  const void* srcs[kMaxSegs] = {src0, src1, src2, src3};
  const int32_t* idss[kMaxSegs] = {ids0, ids1, ids2, ids3};
  const long long ns[kMaxSegs] = {n0, n1, n2, n3};
  return scatter_segments<false>(srcs, idss, ns, table, num_rows, W,
                                 (cudaStream_t)stream);
}

// The bf16 form: bf16 segments summed in the f32 `workspace` [num_rows, W]
// (zeroed first), then rounded once into the bf16 `table` [num_rows, W],
// all on one stream.
extern "C" int scatter_add_segments_bf16(
    const void* src0, const int32_t* ids0, long long n0, const void* src1,
    const int32_t* ids1, long long n1, const void* src2, const int32_t* ids2,
    long long n2, const void* src3, const int32_t* ids3, long long n3,
    float* workspace, void* table, long long num_rows, long long W,
    void* stream) {
  const void* srcs[kMaxSegs] = {src0, src1, src2, src3};
  const int32_t* idss[kMaxSegs] = {ids0, ids1, ids2, ids3};
  const long long ns[kMaxSegs] = {n0, n1, n2, n3};
  cudaStream_t s = (cudaStream_t)stream;
  const int err = scatter_segments<true>(srcs, idss, ns, workspace, num_rows,
                                         W, s);
  const long long n = num_rows * W;
  if (err != 0 || n == 0) return err;
  const bool vec4 = ((uintptr_t)workspace & 15u) == 0 &&
                    ((uintptr_t)table & 7u) == 0;
  const long long n4 = vec4 ? n / 4 : 0;
  const long long work = n4 + (n - 4 * n4);
  const long long cap = (long long)kBlocksPerSm * num_sms();
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  scatter_add_round_kernel<<<(int)blocks, kThreads, 0, s>>>(
      workspace, (__nv_bfloat16*)table, n, n4);
  return (int)cudaGetLastError();
}

extern "C" const char* scatter_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
