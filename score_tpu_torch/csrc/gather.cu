// Row gather: out[i, :] = table[ids[i], :] for a contiguous [V, W] table.
//
// Replaces score_tpu/kernels/gather.py:gather_rows_pallas (body
// _gather_kernel), which issued one DMA per row with 256 in flight.
//
// Bound on the H100: bytes. Each output byte is one table byte read and one
// written, with no arithmetic, so the kernel can at best run at the card's
// memory bandwidth; at a few thousand rows (the item histories, [4096, 2]
// ids of 360-byte rows: ~3 MB each way, ~2 us) the launch and the host's
// work around it are the cost, and the wrapper keeps that to one ctypes
// call. The design:
//   * rows are cut into vectors of VEC bytes, the widest of 16, 8, 4 and 2
//     that the row length and both base pointers allow (chosen here, not
//     by the caller);
//   * a group of G lanes owns a row, G the power of two that covers the
//     row's vectors, at most 32, and each lane takes K = ceil(vectors / G)
//     of them (K <= 4; longer rows go K * G vectors at a time); one lane
//     of the group reads the id and a shuffle shares it, so no lane
//     divides and no id is read twice;
//   * a group takes U rows a pass, U the fewest (a power of two, at most
//     8 / K) that cover the rows with the groups the card holds at once:
//     each lane then issues U * K independent loads before any of their
//     stores where the rows are many, and few rows spread over as many
//     lanes as there are;
//   * the grid is at most the blocks that are resident at once, looping
//     over the rows in passes; consecutive groups take consecutive rows, so
//     a warp writes one contiguous span, with evict-first stores (st.cs):
//     the output is written once and not read back here, so it should not
//     push the table's rows, which ids repeat, out of L2;
//   * up to 2^20 vectors in all (the item histories' 8192 rows of 360 B, a
//     batch's 65537 rows of 36 B) go to a flat kernel instead: one vector
//     a thread, a single pass, no loop and no idle lanes in a group, whose
//     latency chain (id, row, store) is the shortest; on the card it was
//     0.2-0.5 us faster there than the groups of lanes.
// There is no shared memory, no synchronisation beyond the shuffle, and no
// clamping: an id outside [0, V) is the caller's bug, as on the TPU.
// chip_ab_gather.py times this against another checkout's gather.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;   // loads a lane issues before its stores
constexpr long long kFlatMost = 1 << 20;   // vectors the flat kernel takes

// Index: int where every row and vector offset fits, else long long.
template <typename Vec, int G, int K, int U, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ table,
                   const int32_t* __restrict__ ids, Vec* __restrict__ out,
                   Index n_ids, int vpr) {
  constexpr int kGroupsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);     // lane within the group
  const Index warp = (Index)((blockIdx.x * kThreads + threadIdx.x) >> 5);
  const Index groups = (Index)gridDim.x * (kThreads / G);
  // the warp's first row of each pass decides the trip count, so every
  // lane takes part in every shuffle
  for (Index first = warp * kGroupsPerWarp, row0 = first + lane / G;
       first < n_ids; first += groups * U, row0 += groups * U) {
    Index src[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const Index row = row0 + u * groups;
      int id = 0;
      if (sub == 0 && row < n_ids) id = __ldg(ids + row);
      src[u] = (Index)__shfl_sync(0xffffffffu, id, 0, G) * vpr;
    }
    for (int k0 = sub; k0 < vpr; k0 += G * K) {
      Vec v[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int k = k0 + j * G;
          if (row0 + u * groups < n_ids && k < vpr) {
            v[u][j] = __ldg(table + src[u] + k);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const Index row = row0 + u * groups;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int k = k0 + j * G;
          if (row < n_ids && k < vpr) __stcs(out + row * vpr + k, v[u][j]);
        }
      }
    }
  }
}

// Few vectors: one a thread, in a single pass over a grid that covers them
// all (a division a thread, and no loop).
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
gather_flat_kernel(const Vec* __restrict__ table,
                   const int32_t* __restrict__ ids, Vec* __restrict__ out,
                   int total, int vpr) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < total) {
    const int row = g / vpr;
    __stcs(out + g, __ldg(table + __ldg(ids + row) * vpr + (g - row * vpr)));
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

template <typename Vec, int G, int K, int U, typename Index>
void launch_u(const void* table, const int32_t* ids, void* out,
              long long n_ids, int vpr, cudaStream_t stream) {
  auto kernel = gather_rows_kernel<Vec, G, K, U, Index>;
  // the blocks that are resident at once, found once an instance
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    resident = num_sms() * (per_sm > 0 ? per_sm : 1);
  }
  const long long rows_per_block = (long long)(kThreads / G) * U;
  long long blocks = (n_ids + rows_per_block - 1) / rows_per_block;
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const Vec*)table, ids, (Vec*)out, (Index)n_ids, vpr);
}

// Rows a group takes a pass: the fewest that cover n rows with the groups
// the card holds at once (`cap`), as a power of two up to `most`.
int rows_a_pass(long long n, long long cap, int most) {
  int u = 1;
  while (u < most && (long long)u * cap < n) u *= 2;
  return u;
}

template <typename Vec, int G, int K, typename Index>
void launch_k(const void* table, const int32_t* ids, void* out,
              long long n_ids, int vpr, cudaStream_t s) {
  constexpr int kMostU = kInFlight / K > 1 ? kInFlight / K : 1;
  const int u = rows_a_pass(n_ids, (long long)num_sms() * 2048 / G, kMostU);
  if constexpr (kMostU >= 8) {
    if (u == 8) {
      return launch_u<Vec, G, K, 8, Index>(table, ids, out, n_ids, vpr, s);
    }
  }
  if constexpr (kMostU >= 4) {
    if (u == 4) {
      return launch_u<Vec, G, K, 4, Index>(table, ids, out, n_ids, vpr, s);
    }
  }
  if constexpr (kMostU >= 2) {
    if (u == 2) {
      return launch_u<Vec, G, K, 2, Index>(table, ids, out, n_ids, vpr, s);
    }
  }
  launch_u<Vec, G, K, 1, Index>(table, ids, out, n_ids, vpr, s);
}

template <typename Vec, typename Index>
void launch_i(const void* table, const int32_t* ids, void* out,
              long long n_ids, int vpr, cudaStream_t s) {
  if (vpr <= 1) launch_k<Vec, 1, 1, Index>(table, ids, out, n_ids, vpr, s);
  else if (vpr <= 2) launch_k<Vec, 2, 1, Index>(table, ids, out, n_ids, vpr, s);
  else if (vpr <= 4) launch_k<Vec, 4, 1, Index>(table, ids, out, n_ids, vpr, s);
  else if (vpr <= 8) launch_k<Vec, 8, 1, Index>(table, ids, out, n_ids, vpr, s);
  else if (vpr <= 16) launch_k<Vec, 16, 1, Index>(table, ids, out, n_ids, vpr, s);
  else if (vpr <= 32) launch_k<Vec, 32, 1, Index>(table, ids, out, n_ids, vpr, s);
  else if (vpr <= 64) launch_k<Vec, 32, 2, Index>(table, ids, out, n_ids, vpr, s);
  else launch_k<Vec, 32, 4, Index>(table, ids, out, n_ids, vpr, s);
}

template <typename Vec>
void launch(const void* table, const int32_t* ids, void* out,
            long long n_ids, long long num_rows, int vpr, cudaStream_t s) {
  // 32-bit offsets where every one (and a pass past the end) fits
  const long long most = (n_ids > num_rows ? n_ids : num_rows) * vpr;
  if (n_ids * vpr <= kFlatMost && most < (1LL << 30)) {
    const int total = (int)(n_ids * vpr);
    gather_flat_kernel<Vec><<<(total + kThreads - 1) / kThreads, kThreads, 0,
                              s>>>((const Vec*)table, ids, (Vec*)out, total,
                                   vpr);
  } else if (most < (1LL << 30)) {
    launch_i<Vec, int>(table, ids, out, n_ids, vpr, s);
  } else {
    launch_i<Vec, long long>(table, ids, out, n_ids, vpr, s);
  }
}

}  // namespace

// table [num_rows, row_bytes / itemsize], ids [n_ids] int32 in [0,
// num_rows), out [n_ids, ...] like the table; row_bytes a multiple of 2
// (f32, bf16, int32 rows).
extern "C" int gather_rows(const void* table, const int32_t* ids, void* out,
                           long long n_ids, long long num_rows,
                           long long row_bytes, void* stream) {
  if (n_ids <= 0 || row_bytes <= 0) return 0;
  const uintptr_t a = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  int vec = 16;
  while (vec > 2 && (a & (vec - 1)) != 0) vec >>= 1;
  if ((a & (vec - 1)) != 0) return (int)cudaErrorInvalidValue;
  const long long vpr = row_bytes / vec;
  if (vpr > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int v = (int)vpr;
  switch (vec) {
    case 16: launch<uint4>(table, ids, out, n_ids, num_rows, v, s); break;
    case 8: launch<uint2>(table, ids, out, n_ids, num_rows, v, s); break;
    case 4: launch<uint32_t>(table, ids, out, n_ids, num_rows, v, s); break;
    default: launch<uint16_t>(table, ids, out, n_ids, num_rows, v, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
