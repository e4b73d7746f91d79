// GRU recurrence over T slots, forward only: the encoders' inference path
// (serving, evaluation) in bf16.
//
// Replaces no Pallas kernel. The JAX reference runs the cell under
// lax.scan (score_tpu/nn/encoder.py:GRU), where XLA fuses each step's
// elementwise ops into the two gate products; the port's op-by-op version
// (kernels/gru.py:gru_fwd_plain) launches ~14 torch kernels a step and
// takes the [N, T, 3f] input projection through device memory several
// times. This kernel is that scan, fused: one launch for all T steps.
//
// Math (linear-before-reset), a row and step t at a time, x = xs[:, t]:
//   z  = sigmoid(x Wxz + h Whz + bz)
//   r  = sigmoid(x Wxr + h Whr + br)
//   c  = tanh(x Wxc + r * (h Whc) + bc)
//   h' = mask[t] ? (1 - z) h + z c : h           (h = 0 before step 0)
// bf16 inputs, weights and states. The products accumulate in f32 and the
// gate arithmetic is f32 in registers; h' is rounded to bf16 once a step,
// and that rounded value is both stored and carried, as the op-by-op path
// carries it. Nothing is computed below bf16. sigmoid(v) is 0.5 tanh(v/2)
// + 0.5 and tanh is tanh.approx.f32 (relative error 2^-11, an eighth of
// bf16's spacing): one MUFU operation a gate, 3 an element.
//
// Bound on the H100: N T (d + f) 2 bytes (xs read once, hs written once;
// weights, bias and mask are small beside them) at 3.35 TB/s, or
// N T 2 (d + f) 3f operations at 989 TFLOP/s bf16, the larger. At d = 32,
// f = 64 that is the bytes: 0.135 ms at 262,144 x 9 rows (the serving
// shape) against 0.088 ms of products.
//
// Design:
//   * A warp owns a tile of 16 sequences for all T steps, on mma.sync
//     m16n8k16 bf16 tiles with f32 accumulators, on a persistent grid of
//     the resident blocks, each warp walking tiles at the grid's stride.
//   * Each block stages [Wx; Wh] in shared memory once, as B fragments
//     (one 16-byte load a lane gives an n-tile pair), and b in f32.
//   * The tile's x rows reach shared memory by cp.async (16-byte pieces)
//     in chunks of TC steps, double-buffered: the next chunk, or the next
//     tile's first, is in flight while the warp computes on this one. The
//     wrapper (kernels/gru.py:launch_shape) takes the longest chunk with
//     which two blocks of 8 warps share an SM: 3 steps at d = 32, f = 64,
//     where 16 warps an SM ran 1.17x faster than one block holding all 9.
//     x Wx is computed here, so the [N, T, 3f] projection never reaches
//     device memory.
//   * h stays in registers. The accumulators of an n-tile pair hold, lane
//     for lane, the A fragment of an m16k16 tile, so step t's states
//     (rounded to bf16) are step t+1's A operand of h Wh with no trip
//     through shared memory.
//   * The hidden units go 16 at a time (one A k-step of h'): their z, r,
//     x Wxc and h Whc n-tile pairs, 8 accumulators, then the gates. The
//     c gate keeps h Whc apart from x Wxc, as the cell requires.
//   * Each step's states pass through a per-warp staging row block in
//     shared memory and leave as 16-byte stores, a whole 2f-byte row
//     segment a group of lanes: hs_t is written once, coalesced.
//   * Rows past N (the ragged last tile) read zeros and a false mask and
//     are not stored; a masked slot carries h unchanged, so a row whose
//     mask is all false gives zeros.
//
// ptxas (nvcc 12.8, sm_90a): the d = 32, f = 64 instance 128 registers,
// d = f = 16 75 and d = f = 128 194, none spilling; the 64 width
// instances build in ~60 s.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;          // sequences a warp tile
constexpr int kMaxWarps = 8;       // warps a block
constexpr int kSmemLimit = 232448; // shared memory a block may use (H100)

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of an m16k16 tile from shared memory: lane l gives the
// address of row l % 16, columns 8 (l / 16) .. + 7.
__device__ __forceinline__ void ldmatrix_x4(unsigned a[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// 16 bytes from global to shared memory, asynchronously; `bytes` 0
// zero-fills them and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float logistic(float x) {
  return fmaf(0.5f, tanh_approx(0.5f * x), 0.5f);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Shared memory of a block: the B fragments of Wx and Wh, b in f32, then
// a warp's two x chunk buffers (16 rows of tc * d values, each row padded
// by 16 bytes so that ldmatrix's 8 rows fall on distinct banks) and its
// output staging (16 rows of f values, padded alike).
__host__ __device__ constexpr int x_pitch(int d, int tc) {
  return tc * d * 2 + 16;
}
__host__ __device__ constexpr int out_pitch(int f) { return f * 2 + 16; }
__host__ __device__ constexpr int weight_bytes(int d, int f) {
  return (d + f) * 3 * f * 2 + 3 * f * 4;
}
__host__ __device__ constexpr int warp_bytes(int d, int f, int tc) {
  return 2 * kRows * x_pitch(d, tc) + kRows * out_pitch(f);
}

// Issue the cp.async copies of steps t0 .. t0 + tn - 1 of the 16 rows from
// row0 (rows past N zero-filled) into buf.
template <int D>
__device__ __forceinline__ void issue_chunk(
    const __nv_bfloat16* __restrict__ x, long long N, int T, long long row0,
    int t0, int tn, unsigned char* buf, int pitch, int lane) {
  const int per_row = tn * D / 8;   // 16-byte pieces a row
  for (int i = lane; i < kRows * per_row; i += 32) {
    const int r = i / per_row, c = i - r * per_row;
    const long long row = row0 + r;
    const bool ok = row < N;
    const __nv_bfloat16* src = ok ? x + (row * T + t0) * D + c * 8 : x;
    cp_async16(buf + r * pitch + c * 16, src, ok ? 16 : 0);
  }
}

template <int KX, int KH>
__global__ void __launch_bounds__(kMaxWarps * 32)
gru_fwd_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ mask,
               const __nv_bfloat16* __restrict__ wx,
               const __nv_bfloat16* __restrict__ wh,
               const __nv_bfloat16* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, long long N, int T, int TC) {
  constexpr int D = 16 * KX, F = 16 * KH;
  constexpr int NP = 3 * KH;        // n-tile pairs of the 3f gate columns
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sWx = reinterpret_cast<uint4*>(smem);       // [KX][NP][32]
  uint4* sWh = sWx + KX * NP * 32;                   // [KH][NP][32]
  float* sB = reinterpret_cast<float*>(sWh + KH * NP * 32);   // [3F]

  // B fragment of n-tile nt, k-step ks, lane 4 g + q: b0 = (W[16 ks + 2q],
  // W[16 ks + 2q + 1]) at column 8 nt + g, b1 the same 8 rows on; an
  // n-tile pair's two fragments make one uint4 {b0, b1, b0', b1'}.
  auto stage = [&](const __nv_bfloat16* __restrict__ w, int K, uint4* dst) {
    uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
    const uint16_t* w16 = reinterpret_cast<const uint16_t*>(w);
    for (int e = threadIdx.x; e < K * 3 * F; e += blockDim.x) {
      const int k = e / (3 * F), n = e - k * (3 * F);
      const int kk = k & 15, nt = n >> 3;
      const int lane = 4 * (n & 7) + ((kk & 7) >> 1);
      const int word = (nt & 1) * 2 + (kk >> 3);
      d16[((((k >> 4) * NP + (nt >> 1)) * 32 + lane) * 4 + word) * 2 +
          (kk & 1)] = w16[e];
    }
  };
  stage(wx, D, sWx);
  stage(wh, F, sWh);
  for (int i = threadIdx.x; i < 3 * F; i += blockDim.x) {
    sB[i] = __bfloat162float(bias[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int xp = x_pitch(D, TC), op = out_pitch(F);
  unsigned char* buf0 = reinterpret_cast<unsigned char*>(sB + 3 * F) +
                        warp * warp_bytes(D, F, TC);
  unsigned char* buf1 = buf0 + kRows * xp;
  unsigned char* stg = buf1 + kRows * xp;

  const long long tiles = (N + kRows - 1) / kRows;
  const long long stride = (long long)gridDim.x * (blockDim.x >> 5);
  const int chunks = (T + TC - 1) / TC;
  long long tile = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  int chunk = 0;
  if (tile < tiles) {
    issue_chunk<D>(x, N, T, tile * kRows, 0, min(TC, T), buf0, xp, lane);
  }
  cp_commit();

  unsigned h[KH][4];
  for (int it = 0; tile < tiles; ++it) {
    // the next work item: this tile's next chunk, or the next tile's first
    long long ntile = tile;
    int nchunk = chunk + 1;
    if (nchunk == chunks) {
      nchunk = 0;
      ntile += stride;
    }
    unsigned char* cur = (it & 1) ? buf1 : buf0;
    if (ntile < tiles) {
      const int t0 = nchunk * TC;
      issue_chunk<D>(x, N, T, ntile * kRows, t0, min(TC, T - t0),
                     (it & 1) ? buf0 : buf1, xp, lane);
    }
    cp_commit();
    cp_async_wait<1>();   // this item's chunk has landed
    __syncwarp();

    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < KH; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) h[j][i] = 0u;
      }
    }
    const long long row0 = tile * kRows;
    const long long ra = row0 + g, rb = row0 + g + 8;
    const int t0 = chunk * TC, tn = min(TC, T - t0);
    for (int tl = 0; tl < tn; ++tl) {
      const int t = t0 + tl;
      const bool ma = ra < N && __ldg(mask + ra * T + t) != 0;
      const bool mb = rb < N && __ldg(mask + rb * T + t) != 0;
      unsigned xa[KX][4];
#pragma unroll
      for (int ks = 0; ks < KX; ++ks) {
        ldmatrix_x4(xa[ks], cur + (lane & 15) * xp +
                                (tl * D + 16 * ks + 8 * (lane >> 4)) * 2);
      }
      unsigned hn[KH][4];
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        // units 16 j .. 16 j + 15: n-tile pair j of z, KH + j of r and
        // 2 KH + j of c; lane (g, q) holds rows g and g + 8, columns
        // 2q, 2q + 1 of each n-tile
        float az[2][4], ar[2][4], acx[2][4], ach[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int col = 16 * j + 8 * p + 2 * q;
          const float2 bz = *reinterpret_cast<const float2*>(sB + col);
          const float2 br = *reinterpret_cast<const float2*>(sB + F + col);
          const float2 bc =
              *reinterpret_cast<const float2*>(sB + 2 * F + col);
          az[p][0] = az[p][2] = bz.x;
          az[p][1] = az[p][3] = bz.y;
          ar[p][0] = ar[p][2] = br.x;
          ar[p][1] = ar[p][3] = br.y;
          acx[p][0] = acx[p][2] = bc.x;
          acx[p][1] = acx[p][3] = bc.y;
#pragma unroll
          for (int i = 0; i < 4; ++i) ach[p][i] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KX; ++ks) {
          const uint4* w = sWx + ks * NP * 32 + lane;
          const uint4 wz = w[j * 32], wr = w[(KH + j) * 32],
                      wc = w[(2 * KH + j) * 32];
          mma_bf16(az[0], xa[ks], wz.x, wz.y);
          mma_bf16(az[1], xa[ks], wz.z, wz.w);
          mma_bf16(ar[0], xa[ks], wr.x, wr.y);
          mma_bf16(ar[1], xa[ks], wr.z, wr.w);
          mma_bf16(acx[0], xa[ks], wc.x, wc.y);
          mma_bf16(acx[1], xa[ks], wc.z, wc.w);
        }
#pragma unroll
        for (int ks = 0; ks < KH; ++ks) {
          const uint4* w = sWh + ks * NP * 32 + lane;
          const uint4 wz = w[j * 32], wr = w[(KH + j) * 32],
                      wc = w[(2 * KH + j) * 32];
          mma_bf16(az[0], h[ks], wz.x, wz.y);
          mma_bf16(az[1], h[ks], wz.z, wz.w);
          mma_bf16(ar[0], h[ks], wr.x, wr.y);
          mma_bf16(ar[1], h[ks], wr.z, wr.w);
          mma_bf16(ach[0], h[ks], wc.x, wc.y);
          mma_bf16(ach[1], h[ks], wc.z, wc.w);
        }
        // the gates; A fragment word 2 p + s of h's k-step j is n-tile
        // 2 j + p's accumulators 2 s, 2 s + 1 (row g + 8 s)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const unsigned hw = h[j][2 * p + s];
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float hv = e ? bf16_hi(hw) : bf16_lo(hw);
              const float z = logistic(az[p][2 * s + e]);
              const float r = logistic(ar[p][2 * s + e]);
              const float c =
                  tanh_approx(fmaf(r, ach[p][2 * s + e], acx[p][2 * s + e]));
              v[e] = fmaf(z, c - hv, hv);
            }
            const unsigned nw = (s ? mb : ma) ? pack_bf16x2(v[0], v[1]) : hw;
            hn[j][2 * p + s] = nw;
            *reinterpret_cast<unsigned*>(
                stg + (g + 8 * s) * op + (16 * j + 8 * p + 2 * q) * 2) = nw;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KH; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) h[j][i] = hn[j][i];
      }
      __syncwarp();
      // hs_t of the tile's 16 rows: F / 8 16-byte pieces a row
#pragma unroll
      for (int i = lane; i < kRows * (F / 8); i += 32) {
        const int r = i / (F / 8), c = i - r * (F / 8);
        const long long row = row0 + r;
        if (row < N) {
          *reinterpret_cast<uint4*>(out + (row * T + t) * F + c * 8) =
              *reinterpret_cast<const uint4*>(stg + r * op + c * 16);
        }
      }
      __syncwarp();
    }
    tile = ntile;
    chunk = nchunk;
  }
  cp_async_wait<0>();
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

template <int KX, int KH>
int launch(const void* x, const void* mask, const void* wx, const void* wh,
           const void* b, void* out, long long N, int T, int warps, int tc,
           cudaStream_t stream) {
  auto kernel = gru_fwd_kernel<KX, KH>;
  const int smem = weight_bytes(16 * KX, 16 * KH) +
                   warps * warp_bytes(16 * KX, 16 * KH, tc);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32,
                                                smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (N + kRows - 1) / kRows;
  const long long want = (tiles + warps - 1) / warps;
  const long long cap = (long long)num_sms() * per_sm;
  const int blocks = (int)(want < cap ? want : cap);
  kernel<<<blocks, warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)mask,
      (const __nv_bfloat16*)wx, (const __nv_bfloat16*)wh,
      (const __nv_bfloat16*)b, (__nv_bfloat16*)out, N, T, tc);
  return (int)cudaGetLastError();
}

}  // namespace

// xs [N, T, d], mask [N, T] (bool bytes), Wx [d, 3f], Wh [f, 3f], b [3f],
// all bf16 but the mask, contiguous, xs 16-byte aligned -> hs [N, T, f]
// bf16. d and f are multiples of 16 up to 128; `warps` (1 .. 8) a block,
// chunks of `tc` (1 .. T) steps.
extern "C" int gru_fwd(const void* x, const void* mask, const void* wx,
                       const void* wh, const void* b, void* out, long long N,
                       int T, int d, int f, int warps, int tc,
                       void* stream) {
  if (d < 16 || d > 128 || d % 16 || f < 16 || f > 128 || f % 16 ||
      warps < 1 || warps > kMaxWarps || T < 1 || tc < 1 || tc > T ||
      ((uintptr_t)x & 15) || ((uintptr_t)out & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define GRU_CASE(KX, KH)                                                    \
  case (KX - 1) * 8 + (KH - 1):                                             \
    return launch<KX, KH>(x, mask, wx, wh, b, out, N, T, warps, tc, s);
#define GRU_ROW(KX)                                                         \
  GRU_CASE(KX, 1) GRU_CASE(KX, 2) GRU_CASE(KX, 3) GRU_CASE(KX, 4)           \
  GRU_CASE(KX, 5) GRU_CASE(KX, 6) GRU_CASE(KX, 7) GRU_CASE(KX, 8)
  switch ((d / 16 - 1) * 8 + (f / 16 - 1)) {
    GRU_ROW(1) GRU_ROW(2) GRU_ROW(3) GRU_ROW(4)
    GRU_ROW(5) GRU_ROW(6) GRU_ROW(7) GRU_ROW(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRU_ROW
#undef GRU_CASE
}

extern "C" const char* gru_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
