// Native preprocessing kernels (SURVEY.md §3.1 hot loop).
//
// The port's own copy of score_tpu/native/prep_kernels.cc; keep the two equal.
//
// The adjacency build is the preprocessing bottleneck at Taobao scale
// (~1e8 events): the numpy path is O(E log E) lexsorts; this is an O(E)
// counting-sort + per-row reservoir sample. Exposed via ctypes
// (score_tpu_torch/native/__init__.py); the numpy implementation remains the
// reference and the fallback.
//
// Layout contracts match score_tpu_torch/data/schema.py:
//   dense  int32 [num_slots, num_nodes+1, fanout]   (0-padded)
//   cnt    int32 [num_slots, num_nodes+1]           (<= fanout)
//   indptr int64 [num_slots, num_nodes+2]           (absolute offsets)
//   indices int32 [n_events]                        (sorted within row)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// splitmix64 — deterministic per-row stream for reservoir sampling.
inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// Build one adjacency side from deduplicated (slot, node, nbr) triples.
// Returns 0 on success.
int build_side(const int32_t* node, const int32_t* nbr, const int32_t* slot,
               int64_t n_events, int64_t num_nodes, int64_t num_slots,
               int64_t fanout, uint64_t seed, int32_t* dense, int32_t* cnt,
               int64_t* indptr, int32_t* indices) {
  const int64_t rows = num_slots * (num_nodes + 1);

  // 1. row sizes
  std::vector<int64_t> row_count(rows, 0);
  for (int64_t e = 0; e < n_events; ++e) {
    const int64_t key =
        static_cast<int64_t>(slot[e]) * (num_nodes + 1) + node[e];
    if (key < 0 || key >= rows) return 1;
    ++row_count[key];
  }

  // 2. prefix sums -> flat row starts
  std::vector<int64_t> row_start(rows + 1, 0);
  for (int64_t r = 0; r < rows; ++r)
    row_start[r + 1] = row_start[r] + row_count[r];

  // 3. scatter events into CSR order (counting sort, stable)
  std::vector<int64_t> fill(rows, 0);
  for (int64_t e = 0; e < n_events; ++e) {
    const int64_t key =
        static_cast<int64_t>(slot[e]) * (num_nodes + 1) + node[e];
    indices[row_start[key] + fill[key]++] = nbr[e];
  }

  // 4. sort within each row (matches the numpy reference's CSR ordering)
  for (int64_t r = 0; r < rows; ++r)
    std::sort(indices + row_start[r], indices + row_start[r + 1]);

  // 5. indptr [T, N+2]: entry v of slot t = row_start[t*(N+1)+v];
  //    entry N+1 of slot t = start of slot t+1 (== end of its last row)
  for (int64_t t = 0; t < num_slots; ++t) {
    for (int64_t v = 0; v <= num_nodes + 1; ++v) {
      const int64_t flat = std::min(t * (num_nodes + 1) + v, rows);
      indptr[t * (num_nodes + 2) + v] = row_start[flat];
    }
  }

  // 6. dense padded rows: first-fanout of a per-row uniform shuffle
  //    (Fisher-Yates partial shuffle over the row's CSR slice copy)
  std::memset(dense, 0, sizeof(int32_t) * rows * fanout);
  std::memset(cnt, 0, sizeof(int32_t) * rows);
  std::vector<int32_t> scratch;
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t len = row_count[r];
    if (len == 0) continue;
    const int64_t keep = std::min<int64_t>(len, fanout);
    const int64_t node_id = r % (num_nodes + 1);
    if (node_id == 0) continue;  // pad node stays empty
    scratch.assign(indices + row_start[r], indices + row_start[r + 1]);
    uint64_t s = seed ^ (0x9e3779b97f4a7c15ULL * (uint64_t)(r + 1));
    for (int64_t j = 0; j < keep; ++j) {
      const int64_t pick = j + (int64_t)(splitmix64(s) % (uint64_t)(len - j));
      std::swap(scratch[j], scratch[pick]);
      dense[r * fanout + j] = scratch[j];
    }
    cnt[r] = static_cast<int32_t>(keep);
  }
  return 0;
}

// Bucket raw timestamps into equal-width slots (the other O(E) pass).
void bucket_slots(const int64_t* ts, int64_t n, int64_t num_slots,
                  int64_t lo, int64_t hi, int32_t* out) {
  const double width =
      std::max((double)(hi - lo) / (double)num_slots, 1e-9);
  for (int64_t e = 0; e < n; ++e) {
    int64_t s = (int64_t)((double)(ts[e] - lo) / width);
    if (s >= num_slots) s = num_slots - 1;
    if (s < 0) s = 0;
    out[e] = (int32_t)s;
  }
}

}  // extern "C"
