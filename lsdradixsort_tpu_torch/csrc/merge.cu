// 8-way merge passes for Hopper (sm_90a).
//
// Replaces two Pallas kernels of lsdradixsort_tpu/kernels/merge.py:
//
//   * merge_pass_multi (_merge_kernel_multi / _merge_kernel_multi_pipe,
//     merge.py:433, :474):
//     the input is n rows in sorted runs of run_len, the last run ending
//     at n (any n: it may be shorter); every group of up to 8 consecutive
//     runs becomes one sorted run.
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
//     It replaces the TPU's sample-table prepass (merge_pass_tables,
//     lsdradixsort_tpu/kernels/merge.py:75), which only bounded each
//     tile's rows for the VMEM buffers. Brackets around each co-rank
//     come from samples of the runs ranked in shared memory, with a
//     prediction of the co-rank; a warp stages a window of rows around
//     the predictions, finds the cut there and checks it exact (the
//     partition section below gives the argument). Launches top down:
//     the coarse boundaries a CTA each (coarse_splits, sampling in rounds
//     until the check holds), then a CTA a span of 32 tiles between two
//     of them (merge_splits, the span sampled once for its 31
//     boundaries; a boundary whose windows miss is bisected from its
//     sampled brackets).
//   * merge_tiles (lsd_merge_pass, lsd_merge_pass_runs): a persistent
//     grid (the CTAs resident at once), each CTA walking output tiles
//     gridDim.x apart. A tile's windows [c_j(r), c_j(r + kTile)) together
//     hold exactly its rows, so shared memory is bounded whatever the skew
//     (an input-partitioned block's windows in the other runs are not).
//     Warp 0 plans: it reads a tile's co-ranks a tile ahead, lays out its
//     windows, and loads each window of each compared stream with one bulk
//     copy (cp.async.bulk, the TMA's 1-D form) of the window's
//     16-byte-aligned cover, completing on an mbarrier: at ncmp = 1 into a
//     second stage buffer while the current tile merges, else into the one
//     stage buffer as soon as the tile's last level has read it. Warps 1-7
//     merge: a tree of stable 2-way merges, windows in pairs, then quads,
//     then all 8 (ties go to the left half, the lower runs), from the stage
//     buffer to a work buffer and back. At each level a thread writes kRun
//     consecutive rows: a merge-path binary search for its first, then a
//     sequential merge with both candidate rows in registers, one
//     shared-memory load an output (two compared words a row interleaved:
//     one 8-byte load), written straight to the other buffer. The first
//     level reads each window where its copy put it. The compared streams
//     go out coalesced, 16 bytes a thread; a rider is staged in the work
//     buffer and gathered through each row's place in the tile, which the
//     levels carry in two 16-bit arrays.
//
// kTile = 4096 rows, the co-rank table's tile: a buffer is ncmp arrays of
// kTile + 64 words (the covers' slack), so two stage buffers and the work
// buffer take 49 KB at ncmp = 1 (4 CTAs an SM), a stage and the work buffer
// 65 / 98 KB at ncmp = 2 / 3 (3 / 2 CTAs), and riders 16 KB more for the
// places. A smaller tile would need more partition searches, a larger one
// fewer CTAs an SM. A range's co-rank table is 32 bytes a tile, which the
// caller allocates.
//
// What bounds them on the H100. merge_tiles: device-memory bytes, one
// read and one write of every stream, are its floor; what it adds is the
// issue of its three levels, each a chain of some 11 dependent
// shared-memory loads (the search) and kRun dependent merge steps a
// thread, and their bank conflicts, with few warps an SM (its buffers'
// shared memory); and the wait for each tile's load. So a step is one load
// and selects, with no index to follow and no divergent branch, the loads
// land while a merge goes on (this CTA's or another's), and one warp
// issues them and does the planning, off the merging warps' path. The
// partition needs only the table (32 bytes
// a tile), but placing a boundary reads rows scattered over 8 runs: a
// search that probes device memory bracket by bracket (a warp a boundary
// bisecting with 5-way searches: some 15 steps of 28 scattered probes
// from a 16 Ki-row bracket) is bound by those sectors and its chains of
// dependent loads. Here the span's samples (64 rows a run of a 32-tile
// span, 1/256 of its rows) are shared by all its boundaries, the window
// (32 rows a run, contiguous) is the one other read a boundary makes when
// its prediction holds, and every search runs in shared memory; what
// bounds it then is the issue of those searches (the samples' ranking and
// the windows' cuts). Neither pass has a buffer capacity, so no key
// distribution can overflow it (the TPU kernels' skew fallbacks have
// nothing to guard here); a skewed distribution costs the partition extra
// sampling rounds, never exactness.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWay = 8;
constexpr int kMaxStreams = 8;

// The compared words of a row (unused words stay 0).
struct Row {
  uint32_t k, v0, v1;
};

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
// a merge CTA: warp 0 plans and loads the tiles, the others merge them
constexpr int kMergeThreads = 256;
// output rows a thread writes at a level: odd, so that the threads of a
// warp write to different banks; at the first level warp 0 plans and the
// others merge (kRun1 a thread), at the later ones all merge (kRun)
constexpr int kRun1 = kTile / (kMergeThreads - 32) + 1;
constexpr int kRun = kTile / kMergeThreads + 1;
static_assert(kRun1 % 2 == 1 && (kMergeThreads - 32) * kRun1 >= kTile &&
                  kRun % 2 == 1 && kMergeThreads * kRun >= kTile,
              "kRun");

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
// stream, the last run ending at n (it may be shorter); every kWay
// consecutive runs form a merge of their own. A group's tiles are its
// boundaries (its end is implied).
struct Groups {
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
  long long n, run_len, nruns, tiles_per_group, total_tiles;

  __device__ long long tiles() const { return total_tiles; }
  __device__ Merge merge(long long g) const {
    return merge_of(g * tiles_per_group);
  }
  __device__ Merge merge_of(long long b) const {
    Merge m;
    // tile and group counts lie below 2^31: a 32-bit division (warp 0
    // plans each tile with it while the other warps merge)
    const long long g = static_cast<unsigned>(b) /
                        static_cast<unsigned>(tiles_per_group);
    const long long first_run = g * kWay;
    m.nr = static_cast<int>(nruns - first_run < kWay ? nruns - first_run
                                                     : kWay);
    m.b0 = g * tiles_per_group;
    m.base = first_run * run_len;
    m.rows = m.nr * run_len < n - m.base ? m.nr * run_len : n - m.base;
    m.nb = (m.rows + kTile - 1) / kTile;
    m.r0 = 0;
    m.out0 = m.base;
    m.end_stored = false;
    return m;
  }
  __device__ const uint32_t* run(const Merge& m, int j, int t) const {
    return in[t] + m.base + j * run_len;
  }
  __device__ long long lo(int) const { return 0; }
  // run j < m.nr ends at its length: run_len, but for the last run of the
  // pass
  __device__ long long hi(const Merge& m, int j) const {
    const long long left = m.rows - j * run_len;
    return left < run_len ? left : run_len;
  }
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

  __device__ long long tiles() const { return ntiles; }
  __device__ Merge merge(long long) const { return merge_of(0); }
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
  __device__ long long hi(const Merge&, int j) const { return end[j]; }
};

// --- the merge-path partition --------------------------------------------
//
// corank[b * 8 + j] = c_j(r_b), the rows of run j of boundary b's merge
// that the merged order puts before its rank r_b (0 for j >= the merge's
// run count). Everything below rests on one fact. Let brackets lo_j <= c_j
// <= hi_j hold the true co-ranks of rank r. A row x of run j at position
// q in [lo_j, hi_j) lies before r iff its clamped rank, q plus the sum
// over the other runs m of its rank in m clamped to [lo_m, hi_m], is below
// r: so a row is ranked against the other runs' brackets only, and a
// bracket's rows suffice to place it.
//
// Sample sets. A set takes every step_j-th row of each bracket (at most M
// a run) into shared memory and ranks each sample x against the other
// runs' samples there: if a of run m's samples lie before x, its rank in
// m lies between the (a - 1)-th sample's position + 1 and the a-th
// sample's position, so its clamped rank lies in [gl, gu] (gl = gu where
// every step is 1). gl and gu grow with the sample's position, so each
// run's bracket for a rank r shrinks by two binary searches over its own
// samples: after the last with gu < r (before r), up to the first with gl
// >= r (not before r). gh, the clamped rank with each position in another
// run interpolated between its two samples on the compared words, predicts
// where each run's co-rank lies.
//
// The finish (a warp a boundary, 4 lanes a run): each run's window of
// kWin rows around its prediction, inside its bracket, is staged in shared
// memory, and each run's cut found there by a binary search over its
// window (a row's clamped rank in the windows: its position plus its rank
// in the 7 other windows, 2 a lane); the cut is checked: it is the true
// one iff it holds r rows and every row left of it lies before every row
// right of it (the rows beside the cut, where the brackets do not settle
// them). A miss is tried once more with each window moved to the cut the
// first found (a prediction a few rows off puts it at a window's edge).
//
// Launches, top down. coarse_splits, a level a launch: a CTA for each
// boundary at a multiple of kFan^K tiles of a merge (and a range's stored
// end), its brackets the windows; then one for each at a multiple of
// kFan^k, k = K - 1 .. 1, its brackets the exact co-ranks of the kFan^(k
// + 1)-tile span around it. A CTA works in rounds (cta_rounds): it
// samples its brackets (kSpanM a run), warp 0 takes the brackets and
// predictions the samples give and tries its windows, until the check
// holds; a round shrinks the widest bracket to at most about half
// whatever the keys (at most 14 of its samples straddle r), so the rounds
// end. merge_splits: a CTA for each span of kFan tiles between two coarse
// boundaries (whose exact co-ranks bracket exactly the span's rows),
// sampled once (kSpanM a run: every 256th row of a uniform pass), then a
// warp a boundary; a boundary whose windows miss twice (rare on uniform
// keys; common where the keys jump inside a sample gap, as a query's
// rejected rows, all on one key, make them) is finished by its warp with
// the exact bisection of merge-path in device memory (bisect), from the
// brackets its samples prove.

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitCtas = 4;  // resident a SM: at most 64 registers
constexpr int kFan = 32;        // tiles a span, between coarse boundaries
constexpr int kSpanM = 64;      // samples a run of a CTA's set
constexpr int kWin = 32;        // window rows a run around a prediction
constexpr int kWinRows = kWin + 2;  // with the rows on either side
constexpr int kWinLoads = (kWinRows + 3) / 4;  // rows a lane stages
constexpr int kCutSteps = 6;    // a binary search over kWin + 1 positions
static_assert(kWin + 1 <= (1 << kCutSteps), "kCutSteps too few");
constexpr int kMaxRounds = 64;  // sampling rounds: each halves a bracket
// samples a thread loads
constexpr int kSpanLoads = (kWay * kSpanM + kSplitThreads - 1) / kSplitThreads;

// A sample set's brackets and layout, in shared memory: run j's samples
// are [off[j], off[j + 1]), sample i at position lo[j] + i * step[j].
struct SampleSet {
  long long lo[kWay], hi[kWay], step[kWay];
  int off[kWay + 1];
  double end_rank;  // the sum of hi: the rank the brackets end at
};

// A sample set's rows and ranks in shared memory (cap samples).
template <int NC>
struct SampleRows {
  uint32_t* w[3];
  long long *gl, *gu;
  double* gh;
  __device__ Row row(int q) const {
    return Row{w[0][q], NC >= 2 ? w[1][q] : 0u, NC >= 3 ? w[2][q] : 0u};
  }
};

template <int NC>
__host__ __device__ constexpr int sample_bytes(int cap) {
  return cap * (3 * 8 + 4 * NC);
}

template <int NC>
__device__ SampleRows<NC> carve(unsigned char* base, int cap) {
  SampleRows<NC> s;
  s.gh = reinterpret_cast<double*>(base);
  s.gl = reinterpret_cast<long long*>(base + 8 * cap);
  s.gu = s.gl + cap;
  uint32_t* w = reinterpret_cast<uint32_t*>(s.gu + cap);
  for (int t = 0; t < 3; ++t) s.w[t] = t < NC ? w + t * cap : nullptr;
  return s;
}

// The value the predictions interpolate on: the first two compared words
// as one 64-bit number (ties past them change no prediction much). Only
// differences of it are taken, in integers: a double would lose the second
// word under a tied first one (a query's rejected rows share one key).
template <int NC>
__device__ __forceinline__ unsigned long long xkey(const Row& x) {
  return NC == 1 ? x.k : static_cast<unsigned long long>(x.k) << 32 | x.v0;
}

// Rows staged in shared memory: row i of a run's window.
template <int NC>
struct StagedRows {
  const uint32_t *k, *v0, *v1;
  __device__ Row at(int i) const {
    return Row{k[i], NC >= 2 ? v0[i] : 0u, NC >= 3 ? v1[i] : 0u};
  }
};

// The step and layout of a set whose brackets lo, hi are in place, at
// most m samples a run (one thread).
__device__ void finish_set(SampleSet& set, int m) {
  int acc = 0;
  double end = 0;
  for (int j = 0; j < kWay; ++j) {
    // a bracket lies in a run of at most 2^31 - 1 rows: 32-bit division
    const unsigned w = static_cast<unsigned>(set.hi[j] - set.lo[j]);
    const unsigned um = static_cast<unsigned>(m);
    const unsigned step = w > um ? (w + um - 1) / um : 1u;
    set.step[j] = step;
    set.off[j] = acc;
    acc += static_cast<int>((w + step - 1) / step);
    end += static_cast<double>(set.hi[j]);
  }
  set.off[kWay] = acc;
  set.end_rank = end;
}

__device__ __forceinline__ int run_of_sample(const SampleSet& set, int q) {
  int j = 0;
  while (set.off[j + 1] <= q) ++j;
  return j;
}

// Thread `tid` of `nth` loads its samples' compared words (at most PER),
// every load issued before any store.
template <int NC, int PER, class P>
__device__ void load_samples(const P& p, const Merge& m, const SampleSet& set,
                             const SampleRows<NC>& s, int tid, int nth) {
  const int total = set.off[kWay];
  uint32_t v[PER][NC];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int q = tid + e * nth;
    if (q < total) {
      const int j = run_of_sample(set, q);
      const long long pos = set.lo[j] + (q - set.off[j]) * set.step[j];
#pragma unroll
      for (int t = 0; t < NC; ++t) v[e][t] = p.run(m, j, t)[pos];
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int q = tid + e * nth;
    if (q < total) {
#pragma unroll
      for (int t = 0; t < NC; ++t) s.w[t][q] = v[e][t];
    }
  }
}

// Sample x of run j (compared words, xkey xk) in run mr != j of a set:
// the bounds of its clamped rank there, and its interpolated position.
template <int NC>
__device__ void term(const SampleSet& set, const SampleRows<NC>& s,
                     const Row& x, unsigned long long xk, int j, int mr,
                     long long& lower, long long& upper, double& est) {
  const int o = set.off[mr], cnt = set.off[mr + 1] - o;
  const long long lo = set.lo[mr], st = set.step[mr];
  if (cnt == 0) {  // an empty bracket: the clamped rank is lo
    lower = upper = lo;
    est = static_cast<double>(lo);
    return;
  }
  // a: run mr's samples before x (equal ones too if mr precedes j)
  int a = 0, b = cnt;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (before<NC>(s.row(o + mid), x, mr < j)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  lower = a == 0 ? lo : lo + (a - 1) * st + 1;
  upper = a == cnt ? set.hi[mr] : lo + a * st;
  if (a == 0) {
    est = static_cast<double>(lo);
  } else if (a == cnt) {
    est = 0.5 * static_cast<double>(lower + upper);
  } else {  // interpolated between the two samples around x
    // x0 <= xk <= x1: sample a - 1 lies before x, sample a does not
    const unsigned long long x0 = xkey<NC>(s.row(o + a - 1));
    const unsigned long long x1 = xkey<NC>(s.row(o + a));
    float f = x1 > x0 && xk >= x0
                  ? __fdividef(static_cast<float>(xk - x0),
                               static_cast<float>(x1 - x0))
                  : 0.5f;
    f = fminf(fmaxf(f, 0.0f), 1.0f);
    est = static_cast<double>(lower - 1) + static_cast<double>(f * st);
  }
}

// Thread `tid` of `nth` ranks its samples: gl, gu and gh.
template <int NC>
__device__ void rank_samples(const SampleSet& set, const SampleRows<NC>& s,
                             int tid, int nth) {
  for (int q = tid; q < set.off[kWay]; q += nth) {
    const int j = run_of_sample(set, q);
    const long long pos = set.lo[j] + (q - set.off[j]) * set.step[j];
    const Row x = s.row(q);
    const unsigned long long xk = xkey<NC>(x);
    long long gl = pos, gu = pos;
    double gh = static_cast<double>(pos);
    for (int mr = 0; mr < kWay; ++mr) {
      if (mr == j) continue;
      long long lower, upper;
      double est;
      term<NC>(set, s, x, xk, j, mr, lower, upper, est);
      gl += lower;
      gu += upper;
      gh += est;
    }
    s.gl[q] = gl;
    s.gu[q] = gu;
    s.gh[q] = gh;
  }
}

// Run j's predicted co-rank for rank r, from a ranked set.
template <int NC>
__device__ double predict(const SampleSet& set, const SampleRows<NC>& s,
                          int j, long long r) {
  const int o = set.off[j], cnt = set.off[j + 1] - o;
  const double rd = static_cast<double>(r);
  int a = 0, b = cnt;  // the first sample predicted at or after r
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (s.gh[o + mid] < rd) a = mid + 1; else b = mid;
  }
  if (a == 0) return static_cast<double>(set.lo[j]);
  const long long st = set.step[j];
  const double x0 = static_cast<double>(set.lo[j] + (a - 1) * st);
  const double g0 = s.gh[o + a - 1];
  const double x1 = a < cnt ? static_cast<double>(set.lo[j] + a * st)
                            : static_cast<double>(set.hi[j]);
  const double g1 = a < cnt ? s.gh[o + a] : set.end_rank;
  return g1 > g0 ? x0 + (x1 - x0) * (rd - g0) / (g1 - g0) : x0;
}

// Run j's bracket [lo, hi] for rank r from a ranked set.
template <int NC>
__device__ void bracket_of(const SampleSet& set, const SampleRows<NC>& s,
                           int j, long long r, long long& lo,
                           long long& hi) {
  lo = set.lo[j];
  hi = set.hi[j];
  const int o = set.off[j], cnt = set.off[j + 1] - o;
  const long long st = set.step[j];
  int a = 0, b = cnt;  // the first sample with gu >= r
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (s.gu[o + mid] < r) a = mid + 1; else b = mid;
  }
  if (a > 0) lo = set.lo[j] + (a - 1) * st + 1;
  a = 0;
  b = cnt;  // the first sample with gl >= r
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (s.gl[o + mid] < r) a = mid + 1; else b = mid;
  }
  if (a < cnt) hi = set.lo[j] + a * st;
}

// Per run (4 lanes a run, warp-wide): the brackets also cut to what the
// others allow (the co-ranks sum to r).
__device__ __forceinline__ void settle(long long r, long long& lo,
                                       long long& hi) {
  const int sub = threadIdx.x & 3;
  const long long slo = warp_sum(sub == 0 ? lo : 0);
  const long long shi = warp_sum(sub == 0 ? hi : 0);
  const long long a = r - (shi - hi), c = r - (slo - lo);
  lo = a > lo ? a : lo;
  hi = c < hi ? c : hi;
}

// A prediction rounded into [lo, hi].
__device__ __forceinline__ long long clamp_pred(double pred, long long lo,
                                                long long hi) {
  const long long p = llround(pred);
  return p < lo ? lo : p > hi ? hi : p;
}

// Each run's cut in the staged windows [wl_j, wh_j] for r rows (positions
// from each run's first staged row): a binary search over the run's
// window for its first row whose clamped rank in the windows is r or
// more. The 4 lanes of a run rank that row in the other 7 windows, 2 each
// at most, each search kept inside what the earlier steps left for it
// (the ranks grow with the row). Exact whenever the windows hold the true
// co-ranks.
template <int NC>
__device__ int window_cut(const uint32_t* win, int wl, int wh, int r) {
  const int lane = threadIdx.x & 31, run = lane >> 2, sub = lane & 3;
  auto rows_of = [&](int j) {
    return StagedRows<NC>{win + j * kWinRows,
                          NC >= 2 ? win + (kWay + j) * kWinRows : nullptr,
                          NC >= 3 ? win + (2 * kWay + j) * kWinRows
                                  : nullptr};
  };
  // the other runs this lane ranks in, and their windows
  int m[2], ml[2], mh[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int o = sub + 4 * u;  // the o-th run other than this one
    m[u] = o < kWay - 1 ? (o < run ? o : o + 1) : -1;
    // every lane takes part in the shuffles (one with no run, its own)
    const int src = m[u] >= 0 ? m[u] * 4 : lane;
    const int l = __shfl_sync(0xffffffffu, wl, src);
    const int h = __shfl_sync(0xffffffffu, wh, src);
    ml[u] = m[u] >= 0 ? l : 0;
    mh[u] = m[u] >= 0 ? h : 0;
  }
  const StagedRows<NC> own = rows_of(run);
  const StagedRows<NC> other[2] = {rows_of(m[0] >= 0 ? m[0] : run),
                                   rows_of(m[1] >= 0 ? m[1] : run)};
  int lo = wl, hi = wh;  // the cut lies in [lo, hi]
  int rl[2] = {ml[0], ml[1]}, rh[2] = {mh[0], mh[1]};
#pragma unroll 1
  for (int step = 0; step < kCutSteps; ++step) {
    const int i = (lo + hi) >> 1;
    const bool live = lo < hi;
    const Row x = live ? own.at(i) : Row{0u, 0u, 0u};
    // the rows of each of this lane's two windows before x: two binary
    // searches side by side
    int a[2], b[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      a[u] = rl[u];
      b[u] = live && m[u] >= 0 ? rh[u] : rl[u];
    }
    while (a[0] < b[0] || a[1] < b[1]) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (a[u] < b[u]) {
          const int mid = (a[u] + b[u]) >> 1;
          if (before<NC>(other[u].at(mid), x, m[u] < run)) {
            a[u] = mid + 1;
          } else {
            b[u] = mid;
          }
        }
      }
    }
    const int rk[2] = {m[0] >= 0 ? a[0] : 0, m[1] >= 0 ? a[1] : 0};
    int sum = rk[0] + rk[1];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (live) {
      if (i + sum < r) {  // row i lies before the cut
        lo = i + 1;
        rl[0] = rk[0];
        rl[1] = rk[1];
      } else {
        hi = i;
        rh[0] = rk[0];
        rh[1] = rk[1];
      }
    }
  }
  return lo;
}

// One try of the finish (warp-wide): the windows around the predictions
// staged in `win`, each run's cut found there, and the cut checked against
// the brackets [lo, hi] (any that hold the true co-ranks). True, with the
// co-rank in c, iff the cut is the true one; else c is where the windows
// put it.
template <int NC, class P>
__device__ bool window_try(const P& p, const Merge& m, uint32_t* win,
                           long long r, long long lo, long long hi,
                           long long pred, long long& c) {
  const int lane = threadIdx.x & 31, run = lane >> 2, sub = lane & 3;
  long long wl = pred - kWin / 2 > lo ? pred - kWin / 2 : lo;
  const long long wh = wl + kWin < hi ? wl + kWin : hi;
  wl = wh - kWin > lo ? wh - kWin : lo;
  // rows [a, b]: the window and the rows beside it that the check reads
  const long long a = wl - 1 > lo ? wl - 1 : lo;
  const long long b = wh < hi - 1 ? wh : hi - 1;
  uint32_t v[kWinLoads][NC];
#pragma unroll
  for (int e = 0; e < kWinLoads; ++e) {
    const long long q = a + sub + 4 * e;
    if (q <= b) {
#pragma unroll
      for (int t = 0; t < NC; ++t) v[e][t] = p.run(m, run, t)[q];
    }
  }
  // (the loads are in flight) the rows the windows must give
  const long long rest = r - warp_sum(sub == 0 ? a : 0);
  c = wl;
  if (rest < 0 || rest > kWay * kWinRows) return false;  // out of reach
#pragma unroll
  for (int e = 0; e < kWinLoads; ++e) {
    const int i = sub + 4 * e;
    if (a + i <= b) {
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        win[(t * kWay + run) * kWinRows + i] = v[e][t];
      }
    }
  }
  __syncwarp();
  const int cut = window_cut<NC>(win, static_cast<int>(wl - a),
                                 static_cast<int>(wh - a),
                                 static_cast<int>(rest));
  c = a + cut;
  // the check: the cut holds r rows, and row c - 1 of each run (if the
  // brackets leave it open) lies before row c of every other run
  // (likewise)
  bool ok = __reduce_add_sync(0xffffffffu, sub == 0 ? cut : 0) == rest;
  const StagedRows<NC> rows{
      win + run * kWinRows,
      NC >= 2 ? win + (kWay + run) * kWinRows : nullptr,
      NC >= 3 ? win + (2 * kWay + run) * kWinRows : nullptr};
  const bool has_l = c > lo, has_r = c < hi;
  const Row left = has_l ? rows.at(cut - 1) : Row{0u, 0u, 0u};
  const Row right = has_r ? rows.at(cut) : Row{0u, 0u, 0u};
#pragma unroll
  for (int mr = 0; mr < kWay; ++mr) {
    Row y;
    y.k = __shfl_sync(0xffffffffu, right.k, mr * 4);
    y.v0 = __shfl_sync(0xffffffffu, right.v0, mr * 4);
    y.v1 = __shfl_sync(0xffffffffu, right.v1, mr * 4);
    const bool yr = __shfl_sync(0xffffffffu, has_r, mr * 4);
    if (has_l && yr && mr != run && !before<NC>(left, y, run < mr)) {
      ok = false;
    }
  }
  ok = __all_sync(0xffffffffu, ok);
  __syncwarp();  // the windows' last readers are done
  return ok;
}

// A try, and on a miss one more with each window moved to where the first
// put the cut (a prediction a few rows off lands at a window's edge).
template <int NC, class P>
__device__ bool window_tries(const P& p, const Merge& m, uint32_t* win,
                             long long r, long long lo, long long hi,
                             long long pred, long long& c) {
  return window_try<NC>(p, m, win, r, lo, hi, pred, c) ||
         window_try<NC>(p, m, win, r, lo, hi, c, c);
}

// The clamped rank of x in rows [lo, hi) of run `rows` in device memory:
// the first position there whose row is not ordered before x (hi if all
// are). The 4 lanes of a run's group probe 4 evenly spaced rows a step (a
// 5-way search). Called by the whole warp, each group with its own run (lo
// == hi for a group that has nothing to search).
template <int NC>
__device__ long long rank_in_run4(const uint32_t* const* rows, long long lo,
                                  long long hi, const Row& x,
                                  bool or_equal) {
  const int lane = threadIdx.x & 31, sub = lane & 3, first = lane & ~3;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const long long span = hi - lo;
    const long long q = lo + (sub + 1) * span / 5;
    const bool b =
        lo < hi && before<NC>(Row{rows[0][q], NC >= 2 ? rows[1][q] : 0u,
                                  NC >= 3 ? rows[2][q] : 0u},
                              x, or_equal);
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

// The exact cut of r rows from brackets [lo, hi] that hold the true
// co-ranks, in device memory (warp-wide): bisection of the widest bracket,
// its middle row x ranked in the other runs' brackets (rank_in_run4), every
// bracket tightened to x's clamped ranks, until the lower or upper bounds
// sum to r. For a boundary whose windows miss (the keys jump inside a
// sample gap), from the brackets the samples prove.
template <int NC, class P>
__device__ long long bisect(const P& p, const Merge& m, long long lo,
                            long long hi, long long r) {
  const int lane = threadIdx.x & 31, run = lane >> 2, sub = lane & 3;
  const uint32_t* rows[3] = {nullptr, nullptr, nullptr};
  if (run < m.nr) {
    for (int t = 0; t < NC; ++t) rows[t] = p.run(m, run, t);
  }
  while (true) {
    if (warp_sum(sub == 0 ? lo : 0) == r) return lo;
    if (warp_sum(sub == 0 ? hi : 0) == r) return hi;
    // lo sums below r and hi above it: some bracket is not empty
    const long long w = hi - lo;
    const long long wmax = warp_max(w);
    const int js = (__ffs(__ballot_sync(0xffffffffu, w == wmax)) - 1) >> 2;
    const long long mid = __shfl_sync(0xffffffffu, lo + w / 2, js * 4);
    Row x{0u, 0u, 0u};
    if (lane == js * 4) {
      x = Row{rows[0][mid], NC >= 2 ? rows[1][mid] : 0u,
              NC >= 3 ? rows[2][mid] : 0u};
    }
    x.k = __shfl_sync(0xffffffffu, x.k, js * 4);
    if (NC >= 2) x.v0 = __shfl_sync(0xffffffffu, x.v0, js * 4);
    if (NC >= 3) x.v1 = __shfl_sync(0xffffffffu, x.v1, js * 4);
    const bool search = run != js;
    long long rho = rank_in_run4<NC>(rows, search ? lo : 0, search ? hi : 0,
                                     x, run < js);
    if (run == js) rho = mid;
    if (warp_sum(sub == 0 ? rho : 0) < r) {  // x is before r
      lo = run == js ? mid + 1 : rho;
    } else {
      hi = run == js ? mid : rho;
    }
  }
}

// The rank of boundary t of merge m.
__device__ __forceinline__ long long rank_of(const Merge& m, long long t) {
  return m.r0 + (t * kTile < m.rows ? t * kTile : m.rows);
}

// Rows of a CTA's shared memory: its sample set, then a window area a
// warp.
template <int NC>
constexpr size_t split_smem() {
  return sample_bytes<NC>(kWay * kSpanM) +
         static_cast<size_t>(kSplitWarps) * NC * kWay * kWinRows *
             sizeof(uint32_t);
}

// Boundary t of merge m by the whole CTA, its co-ranks inside the
// brackets set.lo, set.hi (in place, and *done 0): warp 0 tries the
// windows, and while the check fails the CTA samples the brackets (kSpanM
// a run) into s and ranks them, and warp 0 takes each run's bracket and
// prediction from them and tries again.
template <int NC, class P>
__device__ void cta_rounds(const P& p, const Merge& m, long long t,
                           SampleSet& set, const SampleRows<NC>& s,
                           uint32_t* win, int* done, int* corank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int run = lane >> 2, sub = lane & 3;
  const long long r = rank_of(m, t);
  for (int round = 0;; ++round) {
    if (warp == 0) {
      long long lo = set.lo[run], hi = set.hi[run];
      double pr = static_cast<double>(lo);
      if (round > 0) {
        bracket_of<NC>(set, s, run, r, lo, hi);
        pr = predict<NC>(set, s, run, r);
      }
      settle(r, lo, hi);
      long long c;
      const bool ok = window_tries<NC>(p, m, win, r, lo, hi,
                                       clamp_pred(pr, lo, hi), c);
      if (ok) {
        if (sub == 0) corank[(m.b0 + t) * kWay + run] = static_cast<int>(c);
        if (lane == 0) *done = 1;
      } else if (sub == 0) {
        set.lo[run] = lo;
        set.hi[run] = hi;
      }
    }
    __syncthreads();
    if (*done) break;
    if (round == kMaxRounds) __trap();  // cannot happen: rounds shrink
    if (threadIdx.x == 0) finish_set(set, kSpanM);
    __syncthreads();
    load_samples<NC, kSpanLoads>(p, m, set, s, threadIdx.x, kSplitThreads);
    __syncthreads();
    rank_samples<NC>(set, s, threadIdx.x, kSplitThreads);
    __syncthreads();
  }
  __syncthreads();  // every thread has read *done
}

// One coarse level: the boundaries at multiples of `stride` tiles, a CTA
// each (`per_merge` CTAs a merge), those at multiples of `parent` left to
// the levels above. At the top (parent 0) every multiple and a range's
// stored end, the brackets the windows; below, the exact co-ranks of the
// span of `parent` tiles around the boundary.
template <int NC, class P>
__global__ void __launch_bounds__(kSplitThreads)
coarse_splits(P p, long long stride, long long parent, long long per_merge,
              int* __restrict__ corank) {
  extern __shared__ __align__(16) unsigned char coarse_mem[];
  __shared__ SampleSet set;
  __shared__ int done;
  const long long g = blockIdx.x / per_merge, k = blockIdx.x % per_merge;
  const Merge m = p.merge(g);
  const long long last = m.nb - 1;
  long long t = k * stride;
  if (parent != 0 && (t % parent == 0 || t >= m.nb)) return;  // the CTA
  if (t >= m.nb) {
    if (!m.end_stored || t - stride >= last) return;  // the whole CTA
    t = last;
  }
  if (threadIdx.x < kWay) {
    const int j = threadIdx.x;
    long long lo = 0, hi = 0;
    if (j < m.nr && parent == 0) {
      lo = p.lo(j);
      hi = p.hi(m, j);
    } else if (j < m.nr) {
      const long long t0 = t - t % parent;
      long long t1 = t0 + parent;
      if (m.end_stored && t1 > last) t1 = last;
      lo = corank[(m.b0 + t0) * kWay + j];
      hi = t1 < m.nb ? corank[(m.b0 + t1) * kWay + j] : p.hi(m, j);
    }
    set.lo[j] = lo;
    set.hi[j] = hi;
  }
  if (threadIdx.x == 0) done = 0;
  __syncthreads();
  cta_rounds<NC>(p, m, t, set, carve<NC>(coarse_mem, kWay * kSpanM),
                 reinterpret_cast<uint32_t*>(
                     coarse_mem + sample_bytes<NC>(kWay * kSpanM)),
                 &done, corank);
}

// The boundaries between the coarse ones: a CTA a span of kFan tiles
// (`per_merge` CTAs a merge), sampled once; a warp a boundary, a window
// around its prediction, or, where the windows miss twice, the bisection
// from the brackets the span's samples prove.
template <int NC, class P>
__global__ void __launch_bounds__(kSplitThreads, kSplitCtas)
merge_splits(P p, long long per_merge, int* __restrict__ corank) {
  extern __shared__ __align__(16) unsigned char split_mem[];
  __shared__ SampleSet span;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int run = lane >> 2, sub = lane & 3;
  const long long g = blockIdx.x / per_merge;
  const long long t0 = blockIdx.x % per_merge * kFan;
  const Merge m = p.merge(g);
  const long long last = m.nb - 1;
  // the span [t0, right]: its exact co-ranks at both ends (a group's end:
  // its runs' lengths), its inner boundaries t0 + 1 .. end - 1
  long long right = t0 + kFan;
  if (m.end_stored && right > last) right = last;
  const long long end = right < m.nb ? right : m.nb;
  if (t0 + 1 >= end) return;  // the whole CTA
  if (threadIdx.x < kWay) {
    const int j = threadIdx.x;
    const bool live = j < m.nr;
    span.lo[j] = live ? corank[(m.b0 + t0) * kWay + j] : 0;
    span.hi[j] = !live           ? 0
                 : right < m.nb ? corank[(m.b0 + right) * kWay + j]
                                : p.hi(m, j);
  }
  __syncthreads();
  if (threadIdx.x == 0) finish_set(span, kSpanM);
  __syncthreads();
  const SampleRows<NC> s = carve<NC>(split_mem, kWay * kSpanM);
  load_samples<NC, kSpanLoads>(p, m, span, s, threadIdx.x, kSplitThreads);
  __syncthreads();
  rank_samples<NC>(span, s, threadIdx.x, kSplitThreads);
  __syncthreads();
  uint32_t* win = reinterpret_cast<uint32_t*>(
                      split_mem + sample_bytes<NC>(kWay * kSpanM)) +
                  warp * NC * kWay * kWinRows;
  for (long long t = t0 + 1 + warp; t < end; t += kSplitWarps) {
    const long long r = rank_of(m, t);
    long long lo = span.lo[run], hi = span.hi[run], c;
    if (!window_tries<NC>(p, m, win, r, lo, hi,
                          clamp_pred(predict<NC>(span, s, run, r), lo, hi),
                          c)) {
      bracket_of<NC>(span, s, run, r, lo, hi);
      settle(r, lo, hi);
      c = bisect<NC>(p, m, lo, hi, r);
    }
    if (sub == 0) corank[(m.b0 + t) * kWay + run] = static_cast<int>(c);
  }
}

// --- the merge of a tile in shared memory ----------------------------------

// Rows a thread stages of a rider, and the words of a stream's array in a
// buffer: a window's 16-byte-aligned cover holds at most 3 words more on
// either side of it (kTile + 48 in all), and a merge may read one row past
// a window's last.
constexpr int kPer = kTile / kMergeThreads;
constexpr int kStride = kTile + 64;
// Compared words a row (the partition's and the merge's ncmp).
constexpr int kMaxCmp = 3;

// The Hopper pieces: an mbarrier in shared memory, and a bulk copy (the
// TMA's 1-D form) from device memory that completes its bytes on one.
__device__ __forceinline__ uint32_t smem_word(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_word(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and the bytes the phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_word(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_word(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from 16-byte-aligned src to 16-byte-aligned dst.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_word(dst)),
      "l"(src), "r"(bytes), "r"(smem_word(bar))
      : "memory");
}

// Orders this thread's writes to shared memory before the bulk copies
// issued after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A tile in shared memory. off: window j is the tile's rows [off[j],
// off[j + 1]) of the merged layout. pos[w][j]: where the bulk copy put
// window j's first row of compared stream w. src[t][j][q]: rider t's row q
// of the tile for q in window j (the run's pointer shifted by off[j]).
struct TilePlan {
  int off[kWay + 1];
  int pos[kMaxCmp][kWay];
  long long out0;  // the output row of the tile's first
  const uint32_t* src[kMaxStreams][kWay];
};

// Lane j < 8 of a warp: run j's window [c0, c1) of tile b (empty for runs
// past the merge's last). The loads are issued here and waited on where
// the values are first used, a tile later.
template <class P>
__device__ __forceinline__ void window_of(const P& p,
                                          const int* __restrict__ corank,
                                          long long b, int& c0, int& c1) {
  const int j = threadIdx.x & (kWay - 1);
  const Merge m = p.merge_of(b);
  // [c_j(b), c_j(b + 1)): the next boundary's co-ranks or, past the
  // merge's stored boundaries, the windows' ends
  c0 = c1 = 0;
  if (j < m.nr) {
    c0 = corank[b * kWay + j];
    c1 = b + 1 < m.b0 + m.nb ? corank[(b + 1) * kWay + j]
                             : static_cast<int>(p.hi(m, j));
  }
}

// The exclusive sum of v over lanes j = 0..7 of each 8 lanes.
__device__ __forceinline__ int lanes8_before(int v) {
  const int j = threadIdx.x & (kWay - 1);
  int sum = v;
#pragma unroll
  for (int d = 1; d < kWay; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, sum, d, kWay);
    if (j >= d) sum += u;
  }
  return sum - v;
}

// A planner lane's bulk copies of a tile: run j's window in compared
// stream w is the 16-byte-aligned cover of `words` words at `from`, which
// lands at word `at` of the stream's stage array; `bytes` is the tile's
// total.
template <int NC>
struct Covers {
  uintptr_t from[NC];
  int words[NC], at[NC];
  int bytes;
};

// Tile b's plan, by the 32 lanes of warp 0 (lane j holding run j's window
// [c0, c1) from window_of), and the covers of its windows' compared rows:
// a window lands at its own alignment and the first level reads it there.
template <int NC, class P>
__device__ Covers<NC> plan_tile(const P& p, int ns, long long b, int c0,
                                int c1, TilePlan& plan) {
  const int lane = threadIdx.x, j = lane & (kWay - 1);
  const Merge m = p.merge_of(b);
  const int len = c1 - c0;
  const int first = lanes8_before(len);
  if (lane < kWay) plan.off[j] = first;
  if (lane == kWay - 1) plan.off[kWay] = first + len;
  if (lane == 0) plan.out0 = m.out0 + (b - m.b0) * kTile;
  for (int t = NC + lane / kWay; t < ns; t += 32 / kWay) {
    plan.src[t][j] = j < m.nr ? p.run(m, j, t) + (c0 - first) : nullptr;
  }
  Covers<NC> c;
  c.bytes = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w) {
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(j < m.nr ? p.run(m, j, w) + c0 : nullptr);
    c.from[w] = a & ~static_cast<uintptr_t>(15);
    const uintptr_t to = (a + 4 * static_cast<uintptr_t>(len) + 15) &
                         ~static_cast<uintptr_t>(15);
    c.words[w] = len > 0 ? static_cast<int>(to - c.from[w]) / 4 : 0;
    c.at[w] = lanes8_before(c.words[w]);
    if (lane < kWay) {
      plan.pos[w][j] = c.at[w] + static_cast<int>(a - c.from[w]) / 4;
    }
    c.bytes += 4 * c.words[w];
  }
#pragma unroll
  for (int d = 1; d < kWay; d <<= 1) {
    c.bytes += __shfl_xor_sync(0xffffffffu, c.bytes, d);
  }
  return c;
}

// The bulk copies of a planned tile into `stage`, completing on `bar`, by
// the 32 lanes of warp 0.
template <int NC>
__device__ __forceinline__ void load_tile(const Covers<NC>& c,
                                          uint32_t* stage, uint64_t* bar) {
  const int lane = threadIdx.x;
  if (lane == 0) mbar_expect(bar, static_cast<uint32_t>(c.bytes));
  __syncwarp();
  if (lane < kWay) {
#pragma unroll
    for (int w = 0; w < NC; ++w) {
      if (c.words[w] > 0) {
        bulk_load(stage + w * kStride + c.at[w],
                  reinterpret_cast<const void*>(c.from[w]),
                  static_cast<uint32_t>(4 * c.words[w]), bar);
      }
    }
  }
}

// The merged layout of a tile's compared words in a buffer, which the
// levels after the first read and write: two words a row interleaved
// (one 8-byte shared-memory access a row), else a stream an array.
template <int NC>
__device__ __forceinline__ Row merged_row(const uint32_t* cmp, int q) {
  if constexpr (NC == 2) {
    const uint2 v = reinterpret_cast<const uint2*>(cmp)[q];
    return Row{v.x, v.y, 0u};
  } else {
    return Row{cmp[q], NC >= 3 ? cmp[kStride + q] : 0u,
               NC >= 3 ? cmp[2 * kStride + q] : 0u};
  }
}

template <int NC>
__device__ __forceinline__ void put_row(uint32_t* cmp, int q, const Row& r) {
  if constexpr (NC == 2) {
    reinterpret_cast<uint2*>(cmp)[q] = make_uint2(r.k, r.v0);
  } else {
    cmp[q] = r.k;
    if (NC >= 3) {
      cmp[kStride + q] = r.v0;
      cmp[2 * kStride + q] = r.v1;
    }
  }
}

// Rider t of the tile into `to`, in the merged layout: each thread issues
// all its loads before it stores any.
__device__ __forceinline__ void stage_rows(const TilePlan& plan, int t,
                                           uint32_t* to) {
  const int rows = plan.off[kWay];
  uint32_t v[kPer];
  int j = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int q = e * kMergeThreads + threadIdx.x;
    if (q < rows) {
      while (plan.off[j + 1] <= q) ++j;
      v[e] = plan.src[t][j][q];
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int q = e * kMergeThreads + threadIdx.x;
    if (q < rows) to[q] = v[e];
  }
}

// One level of the tile's merge tree, from `src` to `dst`: segment s of
// the level is windows [s * W, (s + 1) * W) (W = 2, 4, 8), the stable merge
// of its left half and its right half (ties go left: the lower runs), its
// rows the merged layout's [off[s * W], off[(s + 1) * W]). Thread t writes
// the rows [t * run, (t + 1) * run) (at the first level t counts from warp
// 1, warp 0 planning meanwhile): a merge-path search for its first, then a
// sequential merge whose two candidate rows sit in registers, one
// shared-memory load an output, the read positions selected, not branched
// on. The first level reads each window where its bulk copy put it (pos),
// the later ones the merged layout. With IDX the rows carry their places
// in the merged layout of the tile as staged (isrc to idst; at the first
// level the place is the position itself), for the riders' gather.
template <int NC, bool IDX, int W>
__device__ __forceinline__ void merge_level(const uint32_t* src,
                                            uint32_t* dst,
                                            const uint16_t* isrc,
                                            uint16_t* idst,
                                            const TilePlan& plan, int rows) {
  const int* off = plan.off;
  constexpr int run = W == 2 ? kRun1 : kRun;
  const int o0 = (static_cast<int>(threadIdx.x) - (W == 2 ? 32 : 0)) * run;
  if (o0 >= 0 && o0 < rows) {
    int s = 0;
    while (off[(s + 1) * W] <= o0) ++s;
    // the segment's rows end at hi; either half's next row is read at pa
    // (pb) of stream 0's array, its last before ea (eb); stream w's word
    // is da[w] (db[w]) further; a row at pa has the place pa + sa (first
    // level: its position in the merged layout)
    int hi, pa, pb, ea, eb, sa, sb, da[NC], db[NC];
    auto enter = [&](int seg) {
      const int lo = off[seg * W], mid = off[seg * W + W / 2];
      hi = off[(seg + 1) * W];
      pa = W == 2 ? plan.pos[0][2 * seg] : lo;
      pb = W == 2 ? plan.pos[0][2 * seg + 1] : mid;
      ea = pa + (mid - lo);
      eb = pb + (hi - mid);
      sa = lo - pa;
      sb = mid - pb;
#pragma unroll
      for (int w = 0; w < NC; ++w) {
        da[w] = w * kStride + (W == 2 ? plan.pos[w][2 * seg] - pa : 0);
        db[w] = w * kStride + (W == 2 ? plan.pos[w][2 * seg + 1] - pb : 0);
      }
    };
    // the row at q of the left half's arrays (from_a), else the right's
    auto row = [&](bool from_a, int q) {
      if constexpr (W != 2 && NC == 2) {
        return merged_row<NC>(src, q);
      } else {
        auto at = [&](int w) { return q + (from_a ? da[w] : db[w]); };
        return Row{src[at(0)], NC >= 2 ? src[at(1)] : 0u,
                   NC >= 3 ? src[at(2)] : 0u};
      }
    };
    auto place = [&](bool from_a, int q) {
      return W == 2 ? q + (from_a ? sa : sb) : static_cast<int>(isrc[q]);
    };
    enter(s);
    // a: rows of the left half among the segment's first d (ties: left)
    const int d = o0 - (pa + sa);
    int a = d > eb - pb ? d - (eb - pb) : 0, e = d < ea - pa ? d : ea - pa;
    while (a < e) {
      const int h = (a + e) >> 1;
      if (before<NC>(row(false, pb + d - 1 - h), row(true, pa + h), false)) {
        e = h;
      } else {
        a = h + 1;
      }
    }
    pa += a;
    pb += d - a;
    Row ra = row(true, pa), rb = row(false, pb);
    int xa = 0, xb = 0;
    if constexpr (IDX) xa = place(true, pa), xb = place(false, pb);
    int left = hi - o0;  // outputs before the segment's end
#pragma unroll
    for (int k = 0; k < run; ++k) {
      if (k == left) {  // the segment is done: the next that holds rows
        if (o0 + k >= rows) break;
        do enter(++s);
        while (hi == o0 + k);
        left = hi - o0;
        ra = row(true, pa);
        rb = row(false, pb);
        if constexpr (IDX) xa = place(true, pa), xb = place(false, pb);
      }
      const bool take_a =
          pb >= eb || (pa < ea && !before<NC>(rb, ra, false));
      put_row<NC>(dst, o0 + k, take_a ? ra : rb);
      if constexpr (IDX) {
        idst[o0 + k] = static_cast<uint16_t>(take_a ? xa : xb);
      }
      pa += take_a;
      pb += !take_a;
      const Row c = row(take_a, take_a ? pa : pb);
      if (take_a) {
        ra = c;
      } else {
        rb = c;
      }
      if constexpr (IDX) {
        const int xc = place(take_a, take_a ? pa : pb);
        if (take_a) {
          xa = xc;
        } else {
          xb = xc;
        }
      }
    }
  }
  __syncthreads();
}

// rows words from shared memory to `to`, coalesced: 16 bytes a thread where
// `to` is 16-byte aligned; gathered through idx when it is given.
__device__ __forceinline__ void store_rows(const uint32_t* from,
                                           const uint16_t* idx, uint32_t* to,
                                           int rows) {
  auto at = [&](int q) { return from[idx ? idx[q] : q]; };
  int q = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(to) & 15) == 0) {
    const int vecs = rows >> 2;
    for (int v = threadIdx.x; v < vecs; v += kMergeThreads) {
      reinterpret_cast<uint4*>(to)[v] =
          idx ? make_uint4(at(4 * v), at(4 * v + 1), at(4 * v + 2),
                           at(4 * v + 3))
              : reinterpret_cast<const uint4*>(from)[v];
    }
    q += vecs << 2;
  }
  for (; q < rows; q += kMergeThreads) to[q] = at(q);
}

// The compared streams of a tile from the merged layout to out[t] + out0:
// 16 bytes a thread where the outputs are 16-byte aligned.
template <int NC>
__device__ __forceinline__ void store_compared(const uint32_t* cmp,
                                               uint32_t* const* out,
                                               long long out0, int rows) {
  if constexpr (NC == 2) {
    uint32_t* to0 = out[0] + out0;
    uint32_t* to1 = out[1] + out0;
    int q = threadIdx.x;
    if (((reinterpret_cast<uintptr_t>(to0) |
          reinterpret_cast<uintptr_t>(to1)) & 15) == 0) {
      const int vecs = rows >> 2;
      const uint4* from = reinterpret_cast<const uint4*>(cmp);
      for (int v = threadIdx.x; v < vecs; v += kMergeThreads) {
        const uint4 a = from[2 * v], b = from[2 * v + 1];
        reinterpret_cast<uint4*>(to0)[v] = make_uint4(a.x, a.z, b.x, b.z);
        reinterpret_cast<uint4*>(to1)[v] = make_uint4(a.y, a.w, b.y, b.w);
      }
      q += vecs << 2;
    }
    for (; q < rows; q += kMergeThreads) {
      to0[q] = cmp[2 * q];
      to1[q] = cmp[2 * q + 1];
    }
  } else {
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      store_rows(cmp + t * kStride, nullptr, out[t] + out0, rows);
    }
  }
}

// Stage buffers a CTA: two at ncmp = 1, where the next tile's copies land
// during this tile's whole merge and 4 CTAs still share an SM; one above,
// where a second would cost a CTA an SM (3 to 2 at ncmp = 2), so the
// copies overlap the tile's store and the other CTAs' merges (each
// measured the faster on the H100: PERF.md, the tile merge's findings).
__host__ __device__ constexpr int merge_stages(int nc) {
  return nc == 1 ? 2 : 1;
}

constexpr size_t merge_smem(int nc, bool with_idx) {
  return (merge_stages(nc) + 1) * static_cast<size_t>(nc) *
             kStride * sizeof(uint32_t) +
         (with_idx ? 2 * kStride * sizeof(uint16_t) : 0);
}

// CTAs resident a SM that the shared memory allows (merge_smem, and 2 KB
// for the plans and the runtime's own), which the registers a thread must
// allow too (__launch_bounds__).
constexpr int merge_ctas(int nc, bool with_idx) {
  return static_cast<int>((227 << 10) / (merge_smem(nc, with_idx) + 2048));
}

// The merge of a pass's tiles: a persistent grid, each CTA walking the
// tiles gridDim.x apart. Warp 0 plans: while warps 1.. merge a tile, it
// plans the next one (the co-ranks it read into registers a tile before)
// and issues its bulk copies as soon as a stage buffer is free, then
// reads the co-ranks of the tile after. A tile's levels go from its stage
// buffer to the work buffer and back; its compared streams are stored
// from the work buffer, then each rider is staged there and gathered
// through the rows' places (IDX).
template <int NC, bool IDX, class P>
__global__ void __launch_bounds__(kMergeThreads, merge_ctas(NC, IDX))
merge_tiles(P p, int ns, const int* __restrict__ corank) {
  constexpr int kStages = merge_stages(NC);
  // the stage buffers, the work buffer, then (IDX) 2 place arrays
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* work = smem + kStages * NC * kStride;
  uint16_t* idx0 = reinterpret_cast<uint16_t*>(work + NC * kStride);
  uint16_t* idx1 = idx0 + kStride;
  __shared__ TilePlan plans[2];
  __shared__ uint64_t landed[kStages];  // a stage buffer's copies are in
  const long long tiles = p.tiles(), step = gridDim.x;
  long long b = blockIdx.x;
  const bool planner = threadIdx.x < 32;
  int c0 = 0, c1 = 0;  // the planner's run j: window of the next tile
  Covers<NC> covers;   // the planner's: the next tile's copies
  if (planner) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(&landed[i]);
    }
    __syncwarp();
    window_of(p, corank, b, c0, c1);
    covers = plan_tile<NC>(p, ns, b, c0, c1, plans[0]);
    load_tile<NC>(covers, smem, &landed[0]);
    if (b + step < tiles) window_of(p, corank, b + step, c0, c1);
  }
  __syncthreads();
  uint32_t parity = 0;  // bit i: the phase of landed[i] to wait for
  for (int k = 0; b < tiles; b += step, k ^= 1) {
    const long long next = b + step;
    const int sk = kStages == 2 ? k : 0, nk = kStages == 2 ? k ^ 1 : 0;
    uint32_t* cmp = smem + sk * NC * kStride;
    const TilePlan& plan = plans[k];
    mbar_wait(&landed[sk], parity >> sk & 1);
    parity ^= 1u << sk;
    __syncthreads();  // the last tile is done with plans[k ^ 1], its stage
    if (planner && next < tiles) {
      covers = plan_tile<NC>(p, ns, next, c0, c1, plans[k ^ 1]);
      if (kStages == 2) {
        load_tile<NC>(covers, smem + nk * NC * kStride, &landed[nk]);
      }
      if (next + step < tiles) window_of(p, corank, next + step, c0, c1);
    }
    const int rows = plan.off[kWay];
    // merge tree: windows in pairs, then quads, then all 8
    merge_level<NC, IDX, 2>(cmp, work, nullptr, idx0, plan, rows);
    merge_level<NC, IDX, 4>(work, cmp, idx0, idx1, plan, rows);
    fence_proxy_async();  // the stage buffer's writes before its next copies
    merge_level<NC, IDX, 8>(cmp, work, idx1, idx0, plan, rows);
    if (kStages == 1 && planner && next < tiles) {
      load_tile<NC>(covers, smem, &landed[0]);
    }
    store_compared<NC>(work, p.out, plan.out0, rows);
    for (int t = NC; t < ns; ++t) {
      __syncthreads();  // the work buffer's last readers are done
      stage_rows(plan, t, work);
      __syncthreads();
      store_rows(work, idx0, p.out[t] + plan.out0, rows);
    }
  }
}

template <int NC, class P>
cudaError_t launch_splits_nc(const P& p, long long merges, long long nb,
                             int* corank, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_splits<NC, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(split_smem<NC>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(merge_splits<NC, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(split_smem<NC>()));
  if (err != cudaSuccess) return err;
  // the coarse boundaries, top down: every kFan^K-th tile's (and a stored
  // end) from the windows, then every kFan^k-th for k = K - 1 .. 1 from
  // the spans above; then the spans of kFan tiles
  const long long spans = (nb + kFan - 1) / kFan;
  long long top = kFan;
  while (top * kFan < nb) top *= kFan;
  for (long long stride = top; stride >= kFan; stride /= kFan) {
    const long long per = (nb + stride - 1) / stride + (stride == top);
    if (merges * per > 0x7fffffffLL) return cudaErrorInvalidValue;
    coarse_splits<NC, P><<<static_cast<unsigned>(merges * per),
                           kSplitThreads, split_smem<NC>(), st>>>(
        p, stride, stride == top ? 0 : stride * kFan, per, corank);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  merge_splits<NC, P><<<static_cast<unsigned>(merges * spans), kSplitThreads,
                        split_smem<NC>(), st>>>(p, spans, corank);
  return cudaGetLastError();
}

// The partition of a pass (policy P, `merges` merges of at most nb
// boundaries each) into corank.
template <class P>
cudaError_t launch_splits(const P& p, long long merges, long long nb,
                          int ncmp, int* corank, cudaStream_t st) {
  switch (ncmp) {
    case 1:
      return launch_splits_nc<1>(p, merges, nb, corank, st);
    case 2:
      return launch_splits_nc<2>(p, merges, nb, corank, st);
    default:
      return launch_splits_nc<3>(p, merges, nb, corank, st);
  }
}

template <int NC, bool IDX, class P>
cudaError_t launch_tiles_nc(const P& p, long long tiles, int ns,
                            const int* corank, cudaStream_t st) {
  // a persistent grid: the CTAs resident at once (cached a device)
  constexpr size_t smem = merge_smem(NC, IDX);
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             merge_tiles<NC, IDX, P>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, merge_tiles<NC, IDX, P>, kMergeThreads, smem)) !=
            cudaSuccess) {
      return err;
    }
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const long long grid = tiles < resident[dev] ? tiles : resident[dev];
  merge_tiles<NC, IDX, P><<<static_cast<unsigned>(grid), kMergeThreads, smem,
                            st>>>(p, ns, corank);
  return cudaGetLastError();
}

// The merge of a pass's tiles through its partition corank.
template <class P>
cudaError_t launch_tiles(const P& p, long long tiles, int ns, int ncmp,
                         const int* corank, cudaStream_t st) {
  const bool riders = ns > ncmp;
  switch (ncmp) {
    case 1:
      return riders ? launch_tiles_nc<1, true>(p, tiles, ns, corank, st)
                    : launch_tiles_nc<1, false>(p, tiles, ns, corank, st);
    case 2:
      return riders ? launch_tiles_nc<2, true>(p, tiles, ns, corank, st)
                    : launch_tiles_nc<2, false>(p, tiles, ns, corank, st);
    default:
      return riders ? launch_tiles_nc<3, true>(p, tiles, ns, corank, st)
                    : launch_tiles_nc<3, false>(p, tiles, ns, corank, st);
  }
}

// Output tiles of a merge pass of n rows in runs of run_len (the last run
// ending at n): the tiles of a full group (of the first group), and in
// all.
void tile_plan(long long n, long long run_len, long long* tiles_per_group,
               long long* total) {
  const long long group = kWay * run_len;
  const long long groups = (n + group - 1) / group;
  const long long first = n < group ? n : group;
  const long long last = n - (groups - 1) * group;
  *tiles_per_group = (first + kTile - 1) / kTile;
  *total = (groups - 1) * *tiles_per_group + (last + kTile - 1) / kTile;
}

bool bad_pass(int ns, long long n, long long run_len, int ncmp) {
  return ns < 1 || ns > kMaxStreams || ncmp < 1 || ncmp > 3 || ncmp > ns ||
         run_len < 1 || run_len > 0x7fffffffLL || n < 0;
}

// The Groups of a pass over in[0, ns) (and out[0, ns) when given).
Groups groups_of(const void* const* in, void* const* out, int ns, long long n,
                 long long run_len) {
  Groups g{};
  for (int t = 0; t < ns; ++t) {
    g.in[t] = static_cast<const uint32_t*>(in[t]);
    g.out[t] = out ? static_cast<uint32_t*>(out[t]) : nullptr;
  }
  g.n = n;
  g.run_len = run_len;
  g.nruns = (n + run_len - 1) / run_len;
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
// sorted runs of run_len, the last ending at n. Returns a cudaError_t.
extern "C" int lsd_merge_path_splits(const void* const* in, long long n,
                                     long long run_len, int ncmp,
                                     void* corank, void* stream) {
  if (bad_pass(ncmp, n, run_len, ncmp)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Groups g = groups_of(in, nullptr, ncmp, n, run_len);
  return launch_splits(g, (g.nruns + kWay - 1) / kWay, g.tiles_per_group,
                       ncmp, static_cast<int*>(corank),
                       static_cast<cudaStream_t>(stream));
}

// One merge pass over `ns` (1..8) u32 streams of n rows, stream 0 the key:
// groups of 8 sorted runs of run_len (the last ending at n) become
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
  return launch_splits(r, 1, r.ntiles + 1, ncmp, static_cast<int*>(corank),
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
