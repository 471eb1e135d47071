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
// merge_pass_multi is a merge-path merge, partitioned by output:
//
//   * merge_splits (lsd_merge_path_splits): for every output tile of kTile
//     rows of a group, the exact co-rank of its first row in each run j of
//     the group: c_j(r), the number of run j's rows that the merged order
//     puts before rank r. It replaces the TPU's sample-table prepass
//     (merge_pass_tables). One warp a boundary, 4 lanes a run, keeps a
//     bracket lo_j <= c_j <= hi_j and bisects the widest: the row x in its
//     middle is ranked in each other run by a 5-way search within that
//     run's bracket (a clamped rank), and x lies before r iff the clamped
//     ranks sum to less than r. Either way every bracket tightens to the
//     clamped ranks, so the search is exact under any key distribution,
//     ties included; it ends when the lower or upper bounds sum to r. Two
//     launches: every 32nd boundary with brackets from the run lengths,
//     then the rest with brackets from those (co-ranks only grow).
//   * merge_tiles (lsd_merge_pass): one CTA an output tile. Its windows
//     [c_j(r), c_j(r + kTile)) together hold exactly the tile's rows, so
//     shared memory is bounded whatever the skew (an input-partitioned
//     block's windows in the other runs are not). The CTA loads the
//     windows' compared words coalesced into shared memory and merges them
//     as a tree of stable 2-way merges, windows in pairs, then quads, then
//     all 8 (ties go to the left half, the lower runs). At each level a
//     thread writes kRun consecutive output positions: one merge-path
//     binary search for its first position, then a sequential merge, one
//     compare an output. The levels move 16-bit row indices, so the rows
//     themselves stay put; every stream is then gathered through the final
//     order (the compared ones from shared memory, each rider first staged
//     there from its windows, read coalesced) and stored coalesced.
//
// kTile = 4096 rows: ncmp compared words and two 16-bit orders a row take
// (4 * ncmp + 4) * 4096 bytes, 32 / 48 / 64 KB for ncmp = 1 / 2 / 3, so 7 /
// 4 / 3 CTAs share an SM's 227 KB (a rider is staged in the first compared
// array once the compared streams are out); a smaller tile would need more
// partition searches, a larger one fewer CTAs an SM.
//
// merge_pass_runs keeps the first Hopper design: a row's output position
// is known without merging. The row x at position p of run i lands at p +
// the sum over the other runs j of rank_j(x), the number of rows of run j
// ordered before x (rows equal to x count when j < i). Each thread owns
// one input row and finds its ranks by binary search. A block owns 256
// consecutive rows of one run, so their ranks in run j lie between the
// ranks of its first and last row: 2 threads a run find those bounds over
// the whole of run j first, and each row then searches only that window.
// Every stream is then scattered to the row's position. It writes a row
// only if its rank falls in [lo, lo + count), and its blocks cover only
// the rows of each run that the host says can (the union of the range's
// table windows, which are rounded to whole table blocks and so also hold
// rows of the neighbouring ranges: those compute their rank and are
// skipped, as is a block whose first and last ranks both miss the range).
//
// What bounds them on the H100: device-memory bytes, one read and one
// write of every stream. merge_tiles reaches them coalesced; its shared-
// memory searches and the partition's dependent loads (bisection steps
// times log2 of a bracket, per boundary) are what it adds. merge_runs'
// searches are dependent loads served mostly from L1/L2, S - 1 windows of
// about log2(window) steps a row, and its writes are scattered. Neither
// pass has a buffer capacity, so no key distribution can overflow it (the
// TPU kernels' skew fallbacks have nothing to guard here).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWay = 8;
constexpr int kMaxStreams = 8;
constexpr int kThreads = 256;

struct Streams {
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
};

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

// First position q in [lo, hi) of the run at `base` whose row is not
// ordered before x (hi if every row is): the rank of x in that run.
template <int NC>
__device__ long long rank_in_run(const uint32_t* __restrict__ k,
                                 const uint32_t* __restrict__ v0,
                                 const uint32_t* __restrict__ v1,
                                 long long base, long long lo, long long hi,
                                 const Row& x, bool or_equal) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (before<NC>(load_row<NC>(k, v0, v1, base + mid), x, or_equal)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// --- merge_pass_multi: merge-path partition, then merge in shared memory

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

// The tile `tile` (of tiles_per_group a group) as its group, its run
// count and its first rank within the group.
struct TileAt {
  long long first_run, r0, group_rows;
  int nr;
};

__device__ __forceinline__ TileAt tile_at(long long tile, long long run_len,
                                          long long nruns,
                                          long long tiles_per_group) {
  TileAt a;
  a.first_run = tile / tiles_per_group * kWay;
  a.r0 = tile % tiles_per_group * kTile;
  a.nr = static_cast<int>(nruns - a.first_run < kWay ? nruns - a.first_run
                                                     : kWay);
  a.group_rows = a.nr * run_len;
  return a;
}

// The clamped rank of x in rows [lo, hi) of the run at `base`: the first
// position there whose row is not ordered before x (hi if all are). The 4
// lanes of a run's group probe 4 evenly spaced rows a step (a 5-way
// search: a third of a binary search's dependent loads). Called by the
// whole warp, each group with its own run (lo == hi for a group that has
// nothing to search): the loop runs until every group is done, so the
// groups' loads go out together rather than one group after another.
template <int NC>
__device__ long long rank_in_run4(const uint32_t* __restrict__ k,
                                  const uint32_t* __restrict__ v0,
                                  const uint32_t* __restrict__ v1,
                                  long long base, long long lo, long long hi,
                                  const Row& x, bool or_equal) {
  const int lane = threadIdx.x & 31, sub = lane & 3, first = lane & ~3;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const long long span = hi - lo;
    const long long p = lo + (sub + 1) * span / 5;
    const bool b =
        lo < hi &&
        before<NC>(load_row<NC>(k, v0, v1, base + p), x, or_equal);
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

// corank[tile * 8 + j] = c_j(first rank of the tile) for run j of its
// group (0 for j >= the group's run count). One warp a tile, 4 lanes a
// run. Level 0 takes every kCoarse-th tile of a group, its brackets only
// what the run lengths allow; level 1 the others, each run's bracket cut
// to the co-ranks of the level-0 tiles on either side (co-ranks only grow
// with the rank): shorter searches, over rows that L2 holds.
constexpr int kCoarse = 32;

template <int NC>
__global__ void __launch_bounds__(kThreads)
merge_splits(const uint32_t* __restrict__ k, const uint32_t* __restrict__ v0,
             const uint32_t* __restrict__ v1, long long run_len,
             long long nruns, long long tiles_per_group,
             long long total_tiles, int level, int* __restrict__ corank) {
  const long long tile =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (tile >= total_tiles) return;  // the whole warp
  const TileAt a = tile_at(tile, run_len, nruns, tiles_per_group);
  const long long t = tile % tiles_per_group;
  if ((t % kCoarse == 0) != (level == 0)) return;
  const int lane = threadIdx.x & 31, run = lane >> 2, sub = lane & 3;
  const long long r = a.r0;
  const bool live = run < a.nr;
  const long long base = (a.first_run + run) * run_len;
  long long lo = 0, hi = 0;
  if (live) {
    const long long rest = a.group_rows - run_len;  // the other runs' rows
    lo = r > rest ? r - rest : 0;
    hi = r < run_len ? r : run_len;
    if (level == 1) {
      const long long below = tile - t % kCoarse;
      const long long above = below + kCoarse;
      const long long c0 = corank[below * kWay + run];
      const long long c1 = (t - t % kCoarse + kCoarse) * kTile < a.group_rows
                               ? corank[above * kWay + run]
                               : run_len;
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
    const Row x =
        load_row<NC>(k, v0, v1, (a.first_run + js) * run_len + mid);
    // the clamped rank of x in this lane's run (its own run: mid)
    const bool search = live && run != js;
    long long rho = rank_in_run4<NC>(k, v0, v1, base, search ? lo : 0,
                                     search ? hi : 0, x, run < js);
    if (run == js) rho = mid;
    if (warp_sum(sub == 0 ? rho : 0) < r) {  // x is before r
      lo = run == js ? mid + 1 : rho;
    } else {
      hi = run == js ? mid : rho;
    }
  }
  if (sub == 0) corank[tile * kWay + run] = static_cast<int>(lo);
}

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

// The tile's rows of one stream, window by window, into shared memory:
// each thread issues all its loads before it stores any.
__device__ __forceinline__ void stage_rows(const uint32_t* __restrict__ in,
                                           const int* off,
                                           const long long* src, int rows,
                                           uint32_t* to) {
  constexpr int kPer = kTile / kMergeThreads;
  uint32_t v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int q = e * kMergeThreads + threadIdx.x;
    if (q < rows) {
      int j = 0;
      while (off[j + 1] <= q) ++j;
      v[e] = in[src[j] + (q - off[j])];
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int q = e * kMergeThreads + threadIdx.x;
    if (q < rows) to[q] = v[e];
  }
}

template <int NC>
__global__ void __launch_bounds__(kMergeThreads)
merge_tiles(Streams s, int ns, long long run_len, long long nruns,
            long long tiles_per_group, const int* __restrict__ corank) {
  extern __shared__ uint32_t smem[];
  uint32_t* cmp = smem;  // NC arrays of kTile words, then the riders' stage
  uint16_t* order0 = reinterpret_cast<uint16_t*>(smem + NC * kTile);
  uint16_t* order1 = order0 + kTile;
  __shared__ int off[kWay + 1];    // window j: [off[j], off[j + 1])
  __shared__ long long src[kWay];  // its first row in the input
  const long long tile = blockIdx.x;
  const TileAt a = tile_at(tile, run_len, nruns, tiles_per_group);
  const bool last = a.r0 + kTile >= a.group_rows;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int j = 0; j < kWay; ++j) {
      const int c0 = j < a.nr ? corank[tile * kWay + j] : 0;
      const int c1 = j >= a.nr ? 0
                     : last    ? static_cast<int>(run_len)
                               : corank[(tile + 1) * kWay + j];
      off[j] = acc;
      src[j] = (a.first_run + j) * run_len + c0;
      acc += c1 - c0;
    }
    off[kWay] = acc;
  }
  __syncthreads();
  const int rows = off[kWay];
#pragma unroll
  for (int w = 0; w < NC; ++w) {
    stage_rows(s.in[w], off, src, rows, cmp + w * kTile);
  }
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
  const long long out0 = a.first_run * run_len + a.r0;
  for (int t = 0; t < ns; ++t) {
    const uint32_t* from = cmp + (t < NC ? t * kTile : 0);
    if (t >= NC) {
      __syncthreads();  // the stage's last readers are done
      stage_rows(s.in[t], off, src, rows, cmp);
      __syncthreads();
    }
    uint32_t* out = s.out[t];
    for (int q = threadIdx.x; q < rows; q += kMergeThreads) {
      out[out0 + q] = from[order0[q]];
    }
  }
}

constexpr size_t merge_smem(int nc) {
  return static_cast<size_t>(nc) * kTile * sizeof(uint32_t) +
         2 * kTile * sizeof(uint16_t);
}

// merge_pass_runs: run s's streams, its length, and the rows
// [first, end) of it that the launch covers, from block block0[s] on.
struct Runs {
  const uint32_t* in[kWay][kMaxStreams];
  uint32_t* out[kMaxStreams];
  long long len[kWay];
  long long first[kWay];
  long long end[kWay];
  long long block0[kWay + 1];
};

template <int NC>
__global__ void __launch_bounds__(kThreads)
merge_runs(Runs r, int nruns, int ns, long long lo_rank, long long count) {
  __shared__ long long win_lo[kWay], win_hi[kWay];
  const long long b = blockIdx.x;
  int i = 0;
  while (i + 1 < nruns && b >= r.block0[i + 1]) ++i;
  const long long p0 = r.first[i] + (b - r.block0[i]) * kThreads;
  const long long p1 = p0 + kThreads < r.end[i] ? p0 + kThreads : r.end[i];
  // pointers are read out of the parameter struct by value: taking their
  // address would copy the struct to local memory
  const uint32_t* xk = r.in[i][0];
  const uint32_t* xv0 = r.in[i][1];
  const uint32_t* xv1 = r.in[i][2];

  if (threadIdx.x < 2 * kWay) {
    const int j = threadIdx.x >> 1;
    const bool last = threadIdx.x & 1;
    if (j < nruns && j != i) {
      const Row x = load_row<NC>(xk, xv0, xv1, last ? p1 - 1 : p0);
      (last ? win_hi : win_lo)[j] = rank_in_run<NC>(
          r.in[j][0], r.in[j][1], r.in[j][2], 0, 0, r.len[j], x, j < i);
    }
  }
  __syncthreads();

  // the block's first and last rows bound every rank it holds: skip a
  // block that lies wholly before or after the range (uniform per block)
  long long first_rank = p0, last_rank = p1 - 1;
  for (int j = 0; j < nruns; ++j) {
    if (j == i) continue;
    first_rank += win_lo[j];
    last_rank += win_hi[j];
  }
  if (last_rank < lo_rank || first_rank >= lo_rank + count) return;

  const long long p = p0 + threadIdx.x;
  if (p >= p1) return;
  const Row x = load_row<NC>(xk, xv0, xv1, p);
  long long pos = p - lo_rank;
  for (int j = 0; j < nruns; ++j) {
    if (j == i) continue;
    pos += rank_in_run<NC>(r.in[j][0], r.in[j][1], r.in[j][2], 0, win_lo[j],
                           win_hi[j], x, j < i);
  }
  if (pos < 0 || pos >= count) return;
  for (int t = 0; t < ns; ++t) r.out[t][pos] = r.in[i][t][p];
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

}  // namespace

// Rows of an output tile of lsd_merge_pass.
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
  long long tpg, total;
  tile_plan(n, run_len, &tpg, &total);
  const long long blocks = (total * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto k = static_cast<const uint32_t*>(in[0]);
  const auto v0 = ncmp >= 2 ? static_cast<const uint32_t*>(in[1]) : nullptr;
  const auto v1 = ncmp >= 3 ? static_cast<const uint32_t*>(in[2]) : nullptr;
  const auto nruns = n / run_len;
  const auto c = static_cast<int*>(corank);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  for (int level = 0; level < 2; ++level) {
    switch (ncmp) {
      case 1:
        merge_splits<1><<<grid, kThreads, 0, st>>>(k, v0, v1, run_len, nruns,
                                                   tpg, total, level, c);
        break;
      case 2:
        merge_splits<2><<<grid, kThreads, 0, st>>>(k, v0, v1, run_len, nruns,
                                                   tpg, total, level, c);
        break;
      default:
        merge_splits<3><<<grid, kThreads, 0, st>>>(k, v0, v1, run_len, nruns,
                                                   tpg, total, level, c);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  Streams s{};
  for (int t = 0; t < ns; ++t) {
    s.in[t] = static_cast<const uint32_t*>(in[t]);
    s.out[t] = static_cast<uint32_t*>(out[t]);
  }
  long long tpg, total;
  tile_plan(n, run_len, &tpg, &total);
  if (total > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto nruns = n / run_len;
  const auto c = static_cast<const int*>(corank);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(total);
  cudaError_t err = cudaSuccess;
  switch (ncmp) {
    case 1:
      err = cudaFuncSetAttribute(merge_tiles<1>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(merge_smem(1)));
      if (err != cudaSuccess) return err;
      merge_tiles<1><<<grid, kMergeThreads, merge_smem(1), st>>>(
          s, ns, run_len, nruns, tpg, c);
      break;
    case 2:
      err = cudaFuncSetAttribute(merge_tiles<2>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(merge_smem(2)));
      if (err != cudaSuccess) return err;
      merge_tiles<2><<<grid, kMergeThreads, merge_smem(2), st>>>(
          s, ns, run_len, nruns, tpg, c);
      break;
    default:
      err = cudaFuncSetAttribute(merge_tiles<3>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(merge_smem(3)));
      if (err != cudaSuccess) return err;
      merge_tiles<3><<<grid, kMergeThreads, merge_smem(3), st>>>(
          s, ns, run_len, nruns, tpg, c);
  }
  return cudaGetLastError();
}

// One range of a merge of `nruns` (1..8) sorted runs in separate buffers,
// `ns` (1..8) u32 streams each, stream 0 the key: in[s * ns + t] is stream
// t of run s, len[s] rows long. Writes the rows of merged ranks
// [lo_rank, lo_rank + count) to out[t][0, count), ordered by the first
// ncmp (1..3) streams. Only rows [first[s], end[s]) of run s are read as
// candidates; every row of the range must lie there. Returns a
// cudaError_t.
extern "C" int lsd_merge_pass_runs(const void* const* in, void* const* out,
                                   int nruns, int ns, const long long* len,
                                   const long long* first,
                                   const long long* end, long long lo_rank,
                                   long long count, int ncmp, void* stream) {
  if (nruns < 1 || nruns > kWay || ns < 1 || ns > kMaxStreams || ncmp < 1 ||
      ncmp > 3 || ncmp > ns || lo_rank < 0 || count < 0) {
    return cudaErrorInvalidValue;
  }
  Runs r{};
  long long blocks = 0;
  for (int s = 0; s < nruns; ++s) {
    if (first[s] < 0 || first[s] > end[s] || end[s] > len[s]) {
      return cudaErrorInvalidValue;
    }
    for (int t = 0; t < ns; ++t) {
      r.in[s][t] = static_cast<const uint32_t*>(in[s * ns + t]);
    }
    r.len[s] = len[s];
    r.first[s] = first[s];
    r.end[s] = end[s];
    r.block0[s] = blocks;
    blocks += (end[s] - first[s] + kThreads - 1) / kThreads;
  }
  r.block0[nruns] = blocks;
  for (int t = 0; t < ns; ++t) r.out[t] = static_cast<uint32_t*>(out[t]);
  if (blocks == 0 || count == 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (ncmp) {
    case 1:
      merge_runs<1><<<grid, kThreads, 0, st>>>(r, nruns, ns, lo_rank, count);
      break;
    case 2:
      merge_runs<2><<<grid, kThreads, 0, st>>>(r, nruns, ns, lo_rank, count);
      break;
    default:
      merge_runs<3><<<grid, kThreads, 0, st>>>(r, nruns, ns, lo_rank, count);
  }
  return cudaGetLastError();
}
