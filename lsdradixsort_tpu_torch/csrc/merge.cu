// 8-way merge passes for Hopper (sm_90a).
//
// Replaces two Pallas kernels of lsdradixsort_tpu/kernels/merge.py:
//
//   * merge_pass_multi (_merge_kernel_multi / _merge_kernel_multi_pipe):
//     the input is n rows in sorted runs of run_len; every group of up to
//     8 consecutive runs becomes one sorted run.
//   * merge_pass_runs (the same bodies, slot-routed): S <= 8 sorted runs,
//     each in a buffer of its own and of its own length, merged into one
//     order of which the launch writes the rows of ranks [lo, lo + count):
//     one range of the chip-scale chunked sort (ops/bigsort.py).
//
// Rows are ordered by the key, then (ncmp >= 2) by payload 0, then
// (ncmp = 3) by payload 1, all unsigned, then by run, then by position in
// the run: a stable merge. Every stream moves with its row.
//
// Both are one merge-path merge, partitioned by output; they differ only
// in where their runs are, a policy both kernels take as a template
// parameter: Groups (merge_pass_multi: groups of 8 runs of run_len in one
// buffer a stream) and Runs (merge_pass_runs: S runs, each stream of each
// in its own buffer, seen through the windows of rows that the host says
// hold the range, whose ranks are global). Two kernels:
//
//   * merge_splits (lsd_merge_path_splits, lsd_merge_runs_splits): for
//     every boundary of the output, a tile's first rank r (and, for a
//     range, its end), the exact co-rank in each run j of its merge: c_j(r),
//     the number of run j's rows that the merged order puts before rank r.
//     It replaces the TPU's sample-table prepass (merge_pass_tables). One
//     warp a boundary, 4 lanes a run, keeps a bracket lo_j <= c_j <= hi_j,
//     first what the windows allow, and bisects the widest: the row x in
//     its middle is ranked in each other run by a 5-way search within that
//     run's bracket (a clamped rank), and x lies before r iff the clamped
//     ranks sum to less than r. Either way every bracket tightens to the
//     clamped ranks, so the search is exact under any key distribution,
//     ties included, and it never leaves the windows (a range's neighbours'
//     rows there are excluded like any other); it ends when the lower or
//     upper bounds sum to r. Two launches: every 32nd boundary (and a
//     range's end) with brackets from the windows, then the rest with
//     brackets from those (co-ranks only grow).
//   * merge_tiles (lsd_merge_pass, lsd_merge_pass_runs): one CTA an output
//     tile. Its windows [c_j(r), c_j(r + kTile)) together hold exactly the
//     tile's rows, so shared memory is bounded whatever the skew (an
//     input-partitioned block's windows in the other runs are not). The
//     CTA loads the windows' compared words coalesced into shared memory
//     and merges them as a tree of stable 2-way merges, windows in pairs,
//     then quads, then all 8 (ties go to the left half, the lower runs). At
//     each level a thread writes kRun consecutive output positions: one
//     merge-path binary search for its first position, then a sequential
//     merge, one compare an output. The levels move 16-bit row indices, so
//     the rows themselves stay put; every stream is then gathered through
//     the final order (the compared ones from shared memory, each rider
//     first staged there from its windows, read coalesced) and stored
//     coalesced.
//
// kTile = 4096 rows: ncmp compared words and two 16-bit orders a row take
// (4 * ncmp + 4) * 4096 bytes, 32 / 48 / 64 KB for ncmp = 1 / 2 / 3, so 7 /
// 4 / 3 CTAs share an SM's 227 KB (a rider is staged in the first compared
// array once the compared streams are out, so riders cost no shared
// memory); a smaller tile would need more partition searches, a larger one
// fewer CTAs an SM. A range's co-rank table is 32 bytes a tile, which the
// caller allocates.
//
// What bounds them on the H100: device-memory bytes, one read and one
// write of every stream. merge_tiles reaches them coalesced; its shared-
// memory searches and the partition's dependent loads (bisection steps
// times log5 of a bracket, per boundary) are what it adds. Neither pass
// has a buffer capacity, so no key distribution can overflow it (the TPU
// kernels' skew fallbacks have nothing to guard here).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWay = 8;
constexpr int kMaxStreams = 8;
constexpr int kThreads = 256;

// The compared words of a row (unused words stay 0).
struct Row {
  uint32_t k, v0, v1;
};

template <int NC>
__device__ __forceinline__ Row load_row(const uint32_t* __restrict__ k,
                                        const uint32_t* __restrict__ v0,
                                        const uint32_t* __restrict__ v1,
                                        long long q) {
  return Row{k[q], NC >= 2 ? v0[q] : 0u, NC >= 3 ? v1[q] : 0u};
}

// Is row y ordered before row x? Rows equal on the compared words count
// as before when `or_equal` (y's run precedes x's run).
template <int NC>
__device__ __forceinline__ bool before(const Row& y, const Row& x,
                                       bool or_equal) {
  if (y.k != x.k) return y.k < x.k;
  if (NC >= 2 && y.v0 != x.v0) return y.v0 < x.v0;
  if (NC >= 3 && y.v1 != x.v1) return y.v1 < x.v1;
  return or_equal;
}

constexpr int kTile = 4096;
constexpr int kMergeThreads = 256;
// output rows a thread merges at each level: odd, so that the threads of a
// warp write to different banks, and kMergeThreads * kRun >= kTile
constexpr int kRun = kTile / kMergeThreads + 1;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// --- where the runs are: the two passes' addressing policies -------------
//
// A merge is up to kWay sorted runs whose merged order is cut into output
// tiles of kTile rows. Its boundaries are its tiles' first ranks, and
// also its last rank where the policy stores it; the partition's table
// has one row of kWay co-ranks a boundary. A run is seen through a
// window [lo(j), hi(j)) of positions that holds every row of the merge's
// ranks; every row before the window ranks before them, every row after
// it after them. Row q of run j (q a position in the run) is run(m, j,
// t)[q] of stream t.

struct Merge {
  long long b0;     // its first boundary (also its first tile)
  long long nb;     // boundaries stored for it
  long long r0;     // the rank of its first boundary
  long long rows;   // ranks from r0 to its end
  long long out0;   // the output row of rank r0
  long long base;   // Groups: the row of its first run in the buffers
  int nr;           // runs
  bool end_stored;  // its end is a stored boundary (the last one)
};

// merge_pass_multi: n rows in sorted runs of run_len, one buffer a
// stream; every kWay consecutive runs form a merge of their own. A
// group's tiles are its boundaries (its end is implied).
struct Groups {
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
  long long run_len, nruns, tiles_per_group, total_tiles;

  __device__ long long boundaries() const { return total_tiles; }
  __device__ long long tiles() const { return total_tiles; }
  __device__ Merge merge_of(long long b) const {
    Merge m;
    const long long g = b / tiles_per_group;
    const long long first_run = g * kWay;
    m.nr = static_cast<int>(nruns - first_run < kWay ? nruns - first_run
                                                     : kWay);
    m.b0 = g * tiles_per_group;
    m.rows = m.nr * run_len;
    m.nb = (m.rows + kTile - 1) / kTile;
    m.r0 = 0;
    m.base = first_run * run_len;
    m.out0 = m.base;
    m.end_stored = false;
    return m;
  }
  __device__ const uint32_t* run(const Merge& m, int j, int t) const {
    return in[t] + m.base + j * run_len;
  }
  __device__ long long lo(int) const { return 0; }
  __device__ long long hi(int) const { return run_len; }
  __device__ long long sum_lo(const Merge&) const { return 0; }
  __device__ long long sum_hi(const Merge& m) const { return m.rows; }
};

// merge_pass_runs: one merge of nruns runs, each stream of each in a
// buffer of its own, of which the launch writes ranks [lo_rank, lo_rank +
// count); run j's window is the rows [first[j], end[j]) the host says can
// hold them. Its boundaries are its tiles' first ranks and its end.
struct Runs {
  const uint32_t* in[kWay][kMaxStreams];
  uint32_t* out[kMaxStreams];
  long long first[kWay], end[kWay];
  long long sum_first, sum_end, lo_rank, count, ntiles;
  int nruns;

  __device__ long long boundaries() const { return ntiles + 1; }
  __device__ long long tiles() const { return ntiles; }
  __device__ Merge merge_of(long long) const {
    Merge m;
    m.b0 = 0;
    m.nb = ntiles + 1;
    m.r0 = lo_rank;
    m.rows = count;
    m.out0 = 0;
    m.base = 0;
    m.nr = nruns;
    m.end_stored = true;
    return m;
  }
  __device__ const uint32_t* run(const Merge&, int j, int t) const {
    return in[j][t];
  }
  __device__ long long lo(int j) const { return first[j]; }
  __device__ long long hi(int j) const { return end[j]; }
  __device__ long long sum_lo(const Merge&) const { return sum_first; }
  __device__ long long sum_hi(const Merge&) const { return sum_end; }
};

// --- the merge-path partition --------------------------------------------

// The clamped rank of x in rows [lo, hi) of the run at k, v0, v1: the
// first position there whose row is not ordered before x (hi if all are).
// The 4 lanes of a run's group probe 4 evenly spaced rows a step (a 5-way
// search: a third of a binary search's dependent loads). Called by the
// whole warp, each group with its own run (lo == hi for a group that has
// nothing to search): the loop runs until every group is done, so the
// groups' loads go out together rather than one group after another.
template <int NC>
__device__ long long rank_in_run4(const uint32_t* __restrict__ k,
                                  const uint32_t* __restrict__ v0,
                                  const uint32_t* __restrict__ v1,
                                  long long lo, long long hi, const Row& x,
                                  bool or_equal) {
  const int lane = threadIdx.x & 31, sub = lane & 3, first = lane & ~3;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const long long span = hi - lo;
    const long long p = lo + (sub + 1) * span / 5;
    const bool b = lo < hi && before<NC>(load_row<NC>(k, v0, v1, p), x,
                                         or_equal);
    // the probes before x are a prefix of the group's 4 (a sorted run)
    const int cnt = __popc((__ballot_sync(0xffffffffu, b) >> first) & 0xFu);
    if (lo < hi) {
      if (cnt == 0) {
        hi = lo + span / 5;
      } else {
        const long long next = lo + cnt * span / 5 + 1;
        if (cnt < 4) hi = lo + (cnt + 1) * span / 5;
        lo = next;
      }
    }
  }
  return lo;
}

// corank[b * 8 + j] = c_j(r_b), the rows of run j of boundary b's merge
// that the merged order puts before its rank r_b (0 for j >= the merge's
// run count). One warp a boundary, 4 lanes a run. Every bracket starts as
// what the windows allow: c_j lies in [lo_j, hi_j] and the co-ranks sum to
// r, so c_j >= r - sum_{k != j} hi_k and c_j <= r - sum_{k != j} lo_k.
// Level 0 takes every kCoarse-th boundary of a merge and its stored end;
// level 1 the others, each run's bracket cut to the co-ranks of the
// level-0 boundaries on either side (co-ranks only grow with the rank):
// shorter searches, over rows that L2 holds.
constexpr int kCoarse = 32;

template <int NC, class P>
__global__ void __launch_bounds__(kThreads)
merge_splits(P p, int level, int* __restrict__ corank) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (b >= p.boundaries()) return;  // the whole warp
  const Merge m = p.merge_of(b);
  const long long t = b - m.b0;
  const long long last = m.b0 + m.nb - 1;  // its last stored boundary
  const bool coarse = t % kCoarse == 0 || (m.end_stored && b == last);
  if (coarse != (level == 0)) return;
  const int lane = threadIdx.x & 31, run = lane >> 2, sub = lane & 3;
  const long long r = m.r0 + (t * kTile < m.rows ? t * kTile : m.rows);
  const bool live = run < m.nr;
  const uint32_t* k = live ? p.run(m, run, 0) : nullptr;
  const uint32_t* v0 = live && NC >= 2 ? p.run(m, run, 1) : nullptr;
  const uint32_t* v1 = live && NC >= 3 ? p.run(m, run, 2) : nullptr;
  long long lo = 0, hi = 0;
  if (live) {
    const long long wlo = p.lo(run), whi = p.hi(run);
    const long long a = r - (p.sum_hi(m) - whi), c = r - (p.sum_lo(m) - wlo);
    lo = a > wlo ? a : wlo;
    hi = c < whi ? c : whi;
    if (level == 1) {
      const long long below = b - t % kCoarse;
      long long above = below + kCoarse;
      if (m.end_stored && above > last) above = last;
      const long long c0 = corank[below * kWay + run];
      const long long c1 = above <= last ? corank[above * kWay + run] : whi;
      lo = c0 > lo ? c0 : lo;
      hi = c1 < hi ? c1 : hi;
    }
  }
  while (true) {
    if (warp_sum(sub == 0 ? lo : 0) == r) break;
    if (warp_sum(sub == 0 ? hi : 0) == r) {
      lo = hi;
      break;
    }
    // lo sums below r and hi above it: some bracket is not empty
    const long long w = hi - lo;
    const long long wmax = warp_max(w);
    const int js = (__ffs(__ballot_sync(0xffffffffu, w == wmax)) - 1) >> 2;
    const long long mid = __shfl_sync(0xffffffffu, lo + w / 2, js * 4);
    // x: row mid of run js, read by that run's first lane
    Row x{0u, 0u, 0u};
    if (lane == js * 4) x = load_row<NC>(k, v0, v1, mid);
    x.k = __shfl_sync(0xffffffffu, x.k, js * 4);
    if (NC >= 2) x.v0 = __shfl_sync(0xffffffffu, x.v0, js * 4);
    if (NC >= 3) x.v1 = __shfl_sync(0xffffffffu, x.v1, js * 4);
    // the clamped rank of x in this lane's run (its own run: mid)
    const bool search = live && run != js;
    long long rho = rank_in_run4<NC>(k, v0, v1, search ? lo : 0,
                                     search ? hi : 0, x, run < js);
    if (run == js) rho = mid;
    if (warp_sum(sub == 0 ? rho : 0) < r) {  // x is before r
      lo = run == js ? mid + 1 : rho;
    } else {
      hi = run == js ? mid : rho;
    }
  }
  if (sub == 0) corank[b * kWay + run] = static_cast<int>(lo);
}

// --- the merge of a tile in shared memory ----------------------------------

// The compared words of row q of the tile in shared memory (kTile apart).
template <int NC>
__device__ __forceinline__ Row row_at(const uint32_t* cmp, int q) {
  return Row{cmp[q], NC >= 2 ? cmp[kTile + q] : 0u,
             NC >= 3 ? cmp[2 * kTile + q] : 0u};
}

// One level of the tile's merge tree: segment s of the level is windows
// [s * w, (s + 1) * w) (w = 2, 4, 8), the stable merge of its left half
// and its right half. Each thread writes the output positions [t * kRun,
// (t + 1) * kRun): a merge-path search for its first position in each
// segment it touches, then a sequential merge. `in` (nullptr at the first
// level: the rows themselves) and `out` hold row indices of the tile.
template <int NC>
__device__ void merge_level(const uint32_t* cmp, const int* off, int w,
                            const uint16_t* in, uint16_t* out, int rows) {
  int o = threadIdx.x * kRun;
  const int o_end = o + kRun < rows ? o + kRun : rows;
  int s = 0;
  while (o < o_end) {
    while (off[(s + 1) * w < kWay ? (s + 1) * w : kWay] <= o) ++s;
    const int lo = off[s * w];
    const int mid = off[s * w + w / 2 < kWay ? s * w + w / 2 : kWay];
    const int hi = off[(s + 1) * w < kWay ? (s + 1) * w : kWay];
    const int n1 = mid - lo, n2 = hi - mid, d = o - lo;
    auto left = [&](int i) { return in ? in[lo + i] : lo + i; };
    auto right = [&](int i) { return in ? in[mid + i] : mid + i; };
    // i: rows of the left half among the segment's first d (ties: left)
    int a = d > n2 ? d - n2 : 0, b = d < n1 ? d : n1;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (!before<NC>(row_at<NC>(cmp, right(d - 1 - m)),
                      row_at<NC>(cmp, left(m)), false)) {
        a = m + 1;
      } else {
        b = m;
      }
    }
    int i = a, j = d - a;
    int li = i < n1 ? left(i) : 0, rj = j < n2 ? right(j) : 0;
    Row lrow = row_at<NC>(cmp, li), rrow = row_at<NC>(cmp, rj);
    const int stop = o_end < hi ? o_end : hi;
    for (; o < stop; ++o) {
      const bool take_left =
          j >= n2 || (i < n1 && !before<NC>(rrow, lrow, false));
      if (take_left) {
        out[o] = static_cast<uint16_t>(li);
        if (++i < n1) {
          li = left(i);
          lrow = row_at<NC>(cmp, li);
        }
      } else {
        out[o] = static_cast<uint16_t>(rj);
        if (++j < n2) {
          rj = right(j);
          rrow = row_at<NC>(cmp, rj);
        }
      }
    }
  }
}

// The tile's rows of one stream, window by window, into shared memory
// (win[j]: the stream's row of window j's first): each thread issues all
// its loads before it stores any.
__device__ __forceinline__ void stage_rows(const uint32_t* const* win,
                                           const int* off, int rows,
                                           uint32_t* to) {
  constexpr int kPer = kTile / kMergeThreads;
  uint32_t v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int q = e * kMergeThreads + threadIdx.x;
    if (q < rows) {
      int j = 0;
      while (off[j + 1] <= q) ++j;
      v[e] = win[j][q - off[j]];
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int q = e * kMergeThreads + threadIdx.x;
    if (q < rows) to[q] = v[e];
  }
}

template <int NC, class P>
__global__ void __launch_bounds__(kMergeThreads)
merge_tiles(P p, int ns, const int* __restrict__ corank) {
  extern __shared__ uint32_t smem[];
  uint32_t* cmp = smem;  // NC arrays of kTile words, then the riders' stage
  uint16_t* order0 = reinterpret_cast<uint16_t*>(smem + NC * kTile);
  uint16_t* order1 = order0 + kTile;
  __shared__ int off[kWay + 1];  // window j: [off[j], off[j + 1])
  // stream t's row of window j's first
  __shared__ const uint32_t* win[kMaxStreams][kWay];
  const long long b = blockIdx.x;
  const Merge m = p.merge_of(b);
  // its windows [c_j(b), c_j(b + 1)), the next boundary's co-ranks or,
  // past the merge's stored boundaries, the windows' ends
  const bool next_stored = b + 1 < m.b0 + m.nb;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int j = 0; j < kWay; ++j) {
      const int c0 = j < m.nr ? corank[b * kWay + j] : 0;
      const int c1 = j >= m.nr      ? 0
                     : next_stored ? corank[(b + 1) * kWay + j]
                                   : static_cast<int>(p.hi(j));
      off[j] = acc;
      acc += c1 - c0;
    }
    off[kWay] = acc;
  }
  if (threadIdx.x < ns * kWay) {
    const int t = threadIdx.x / kWay, j = threadIdx.x % kWay;
    win[t][j] = j < m.nr ? p.run(m, j, t) + corank[b * kWay + j] : nullptr;
  }
  __syncthreads();
  const int rows = off[kWay];
#pragma unroll
  for (int w = 0; w < NC; ++w) stage_rows(win[w], off, rows, cmp + w * kTile);
  __syncthreads();
  // merge tree: windows in pairs, then quads, then all 8
  merge_level<NC>(cmp, off, 2, nullptr, order0, rows);
  __syncthreads();
  merge_level<NC>(cmp, off, 4, order0, order1, rows);
  __syncthreads();
  merge_level<NC>(cmp, off, 8, order1, order0, rows);
  __syncthreads();

  // every stream gathered through the order, stored coalesced: the
  // compared ones from shared memory, then each rider staged in cmp[0..)
  const long long out0 = m.out0 + (b - m.b0) * kTile;
  for (int t = 0; t < ns; ++t) {
    const uint32_t* from = cmp + (t < NC ? t * kTile : 0);
    if (t >= NC) {
      __syncthreads();  // the stage's last readers are done
      stage_rows(win[t], off, rows, cmp);
      __syncthreads();
    }
    uint32_t* out = p.out[t];
    for (int q = threadIdx.x; q < rows; q += kMergeThreads) {
      out[out0 + q] = from[order0[q]];
    }
  }
}

constexpr size_t merge_smem(int nc) {
  return static_cast<size_t>(nc) * kTile * sizeof(uint32_t) +
         2 * kTile * sizeof(uint16_t);
}

// The partition of a pass (policy P) into corank: its two levels.
template <class P>
cudaError_t launch_splits(const P& p, long long boundaries, int ncmp,
                          int* corank, cudaStream_t st) {
  const long long blocks = (boundaries * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto grid = static_cast<unsigned>(blocks);
  for (int level = 0; level < 2; ++level) {
    switch (ncmp) {
      case 1:
        merge_splits<1, P><<<grid, kThreads, 0, st>>>(p, level, corank);
        break;
      case 2:
        merge_splits<2, P><<<grid, kThreads, 0, st>>>(p, level, corank);
        break;
      default:
        merge_splits<3, P><<<grid, kThreads, 0, st>>>(p, level, corank);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int NC, class P>
cudaError_t launch_tiles_nc(const P& p, unsigned grid, int ns,
                            const int* corank, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      merge_tiles<NC, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(merge_smem(NC)));
  if (err != cudaSuccess) return err;
  merge_tiles<NC, P><<<grid, kMergeThreads, merge_smem(NC), st>>>(p, ns,
                                                                  corank);
  return cudaGetLastError();
}

// The merge of a pass's tiles through its partition corank.
template <class P>
cudaError_t launch_tiles(const P& p, long long tiles, int ns, int ncmp,
                         const int* corank, cudaStream_t st) {
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto grid = static_cast<unsigned>(tiles);
  switch (ncmp) {
    case 1:
      return launch_tiles_nc<1>(p, grid, ns, corank, st);
    case 2:
      return launch_tiles_nc<2>(p, grid, ns, corank, st);
    default:
      return launch_tiles_nc<3>(p, grid, ns, corank, st);
  }
}

// Output tiles of a merge pass of n rows in runs of run_len: the tiles of
// a full group (of the first group), and in all.
void tile_plan(long long n, long long run_len, long long* tiles_per_group,
               long long* total) {
  const long long nruns = n / run_len;
  const long long groups = (nruns + kWay - 1) / kWay;
  const long long first = (nruns < kWay ? nruns : kWay) * run_len;
  const long long last = (nruns - (groups - 1) * kWay) * run_len;
  *tiles_per_group = (first + kTile - 1) / kTile;
  *total = (groups - 1) * *tiles_per_group + (last + kTile - 1) / kTile;
}

bool bad_pass(int ns, long long n, long long run_len, int ncmp) {
  return ns < 1 || ns > kMaxStreams || ncmp < 1 || ncmp > 3 || ncmp > ns ||
         run_len < 1 || run_len > 0x7fffffffLL || n < 0 || n % run_len != 0;
}

// The Groups of a pass over in[0, ns) (and out[0, ns) when given).
Groups groups_of(const void* const* in, void* const* out, int ns, long long n,
                 long long run_len) {
  Groups g{};
  for (int t = 0; t < ns; ++t) {
    g.in[t] = static_cast<const uint32_t*>(in[t]);
    g.out[t] = out ? static_cast<uint32_t*>(out[t]) : nullptr;
  }
  g.run_len = run_len;
  g.nruns = n / run_len;
  tile_plan(n, run_len, &g.tiles_per_group, &g.total_tiles);
  return g;
}

// The Runs of one range (lsd_merge_runs_splits, lsd_merge_pass_runs), or
// false if the arguments describe none.
bool runs_of(const void* const* in, void* const* out, int nruns, int ns,
             const long long* len, const long long* first,
             const long long* end, long long lo_rank, long long count,
             int ncmp, Runs* r) {
  if (nruns < 1 || nruns > kWay || ns < 1 || ns > kMaxStreams || ncmp < 1 ||
      ncmp > 3 || ncmp > ns || lo_rank < 0 || count < 0) {
    return false;
  }
  *r = Runs{};
  for (int s = 0; s < nruns; ++s) {
    if (first[s] < 0 || first[s] > end[s] || end[s] > len[s] ||
        len[s] > 0x7fffffffLL) {
      return false;
    }
    for (int t = 0; t < ns; ++t) {
      r->in[s][t] = static_cast<const uint32_t*>(in[s * ns + t]);
    }
    r->first[s] = first[s];
    r->end[s] = end[s];
    r->sum_first += first[s];
    r->sum_end += end[s];
  }
  for (int t = 0; t < ns; ++t) {
    r->out[t] = out ? static_cast<uint32_t*>(out[t]) : nullptr;
  }
  // the range's ranks must lie within the windows
  if (lo_rank < r->sum_first || lo_rank + count > r->sum_end) return false;
  r->nruns = nruns;
  r->lo_rank = lo_rank;
  r->count = count;
  r->ntiles = (count + kTile - 1) / kTile;
  return true;
}

}  // namespace

// Rows of an output tile of lsd_merge_pass and lsd_merge_pass_runs.
extern "C" int lsd_merge_tile() { return kTile; }

// The merge-path partition of one merge pass: corank (total tiles x 8 int32,
// the tile plan of tile_plan) gets, for each output tile, the number of rows
// of each run of its group that the merged order puts before the tile. in[]
// holds the first ncmp (1..3) u32 streams of n rows, stream 0 the key, in
// sorted runs of run_len. Returns a cudaError_t.
extern "C" int lsd_merge_path_splits(const void* const* in, long long n,
                                     long long run_len, int ncmp,
                                     void* corank, void* stream) {
  if (bad_pass(ncmp, n, run_len, ncmp)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Groups g = groups_of(in, nullptr, ncmp, n, run_len);
  return launch_splits(g, g.total_tiles, ncmp, static_cast<int*>(corank),
                       static_cast<cudaStream_t>(stream));
}

// One merge pass over `ns` (1..8) u32 streams of n rows, stream 0 the key:
// groups of 8 sorted runs of run_len (n a multiple of run_len) become
// sorted runs, ordered by the first ncmp (1..3) streams, through the
// partition `corank` of lsd_merge_path_splits. out[] must not alias in[].
// Returns a cudaError_t.
extern "C" int lsd_merge_pass(const void* const* in, void* const* out, int ns,
                              long long n, long long run_len, int ncmp,
                              const void* corank, void* stream) {
  if (bad_pass(ns, n, run_len, ncmp)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Groups g = groups_of(in, out, ns, n, run_len);
  return launch_tiles(g, g.total_tiles, ns, ncmp,
                      static_cast<const int*>(corank),
                      static_cast<cudaStream_t>(stream));
}

// The merge-path partition of one range of a merge of `nruns` (1..8)
// sorted runs in separate buffers (in[s * ns + t]: stream t of run s, len[s]
// rows; only the first ncmp (1..3) streams are read): corank ((ceil(count /
// lsd_merge_tile()) + 1) x 8 int32) gets, for each boundary r = lo_rank +
// min(i * tile, count), the number of rows of each run that the merged
// order puts before rank r. Rows [first[s], end[s]) of run s must hold
// every row of ranks [lo_rank, lo_rank + count), the rows before them
// rank before, the rows after them after. Returns a cudaError_t.
extern "C" int lsd_merge_runs_splits(const void* const* in, int nruns, int ns,
                                     const long long* len,
                                     const long long* first,
                                     const long long* end, long long lo_rank,
                                     long long count, int ncmp, void* corank,
                                     void* stream) {
  Runs r;
  if (!runs_of(in, nullptr, nruns, ns, len, first, end, lo_rank, count, ncmp,
               &r)) {
    return cudaErrorInvalidValue;
  }
  return launch_splits(r, r.ntiles + 1, ncmp, static_cast<int*>(corank),
                       static_cast<cudaStream_t>(stream));
}

// One range of that merge, `ns` (1..8) u32 streams, stream 0 the key,
// through its partition corank (lsd_merge_runs_splits): writes the rows of
// merged ranks [lo_rank, lo_rank + count) to out[t][0, count), ordered by
// the first ncmp (1..3) streams, then run, then position. out[] must not
// alias in[]. Returns a cudaError_t.
extern "C" int lsd_merge_pass_runs(const void* const* in, void* const* out,
                                   int nruns, int ns, const long long* len,
                                   const long long* first,
                                   const long long* end, long long lo_rank,
                                   long long count, int ncmp,
                                   const void* corank, void* stream) {
  Runs r;
  if (!runs_of(in, out, nruns, ns, len, first, end, lo_rank, count, ncmp,
               &r)) {
    return cudaErrorInvalidValue;
  }
  if (count == 0) return cudaSuccess;
  return launch_tiles(r, r.ntiles, ns, ncmp, static_cast<const int*>(corank),
                      static_cast<cudaStream_t>(stream));
}
