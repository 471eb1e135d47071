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
// Design: a row's output position is known without merging. The row x at
// position p of run i lands at p + sum over the other runs j of rank_j(x),
// the number of rows of run j ordered before x (rows equal to x count
// when j < i), plus the group's base. Each thread owns one input row and
// finds its ranks by binary search. A block owns 256 consecutive rows of
// one run, so their ranks in run j lie between the ranks of its first and
// last row: 2 threads a run find those bounds over the whole of run j
// first, and each row then searches only that window. Every stream is
// then scattered to the row's position. merge_pass_runs writes a row only
// if its rank falls in [lo, lo + count), and its blocks cover only the
// rows of each run that the host says can (the union of the range's table
// windows, which are rounded to whole table blocks and so also hold rows
// of the neighbouring ranges: those compute their rank and are skipped,
// as is a block whose first and last ranks both miss the range).
//
// What bounds it on the H100: the searches are dependent loads, S - 1
// windows of about log2(window) steps per row, served mostly from L1/L2;
// the stream traffic itself is one read and one scattered write per word.
// The pass has no buffer capacity, so no key distribution can overflow it
// (the TPU kernels' skew fallbacks have nothing to guard here). Merge-path
// partitioning with shared-memory merges is the next step.
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

template <int NC>
__global__ void __launch_bounds__(kThreads)
merge_pass(Streams s, int ns, long long run_len, long long nruns,
           long long blocks_per_run) {
  __shared__ long long win_lo[kWay], win_hi[kWay];
  const long long run = blockIdx.x / blocks_per_run;
  const long long p0 = (blockIdx.x % blocks_per_run) * kThreads;
  const long long p1 = p0 + kThreads < run_len ? p0 + kThreads : run_len;
  const int i = static_cast<int>(run % kWay);
  const long long first_run = run - i;
  const int nr = static_cast<int>(
      nruns - first_run < kWay ? nruns - first_run : kWay);
  const uint32_t* k = s.in[0];
  const uint32_t* v0 = s.in[1];
  const uint32_t* v1 = s.in[2];
  const long long ibase = run * run_len;

  if (threadIdx.x < 2 * kWay) {
    const int j = threadIdx.x >> 1;
    const bool last = threadIdx.x & 1;
    if (j < nr && j != i) {
      const Row x = load_row<NC>(k, v0, v1, ibase + (last ? p1 - 1 : p0));
      (last ? win_hi : win_lo)[j] = rank_in_run<NC>(
          k, v0, v1, (first_run + j) * run_len, 0, run_len, x, j < i);
    }
  }
  __syncthreads();

  const long long p = p0 + threadIdx.x;
  if (p >= p1) return;
  const long long q = ibase + p;
  const Row x = load_row<NC>(k, v0, v1, q);
  long long pos = first_run * run_len + p;
  for (int j = 0; j < nr; ++j) {
    if (j == i) continue;
    pos += rank_in_run<NC>(k, v0, v1, (first_run + j) * run_len, win_lo[j],
                           win_hi[j], x, j < i);
  }
  for (int t = 0; t < ns; ++t) s.out[t][pos] = s.in[t][q];
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

}  // namespace

// One merge pass over `ns` (1..8) u32 streams of n rows, stream 0 the key:
// groups of 8 sorted runs of run_len (n a multiple of run_len) become
// sorted runs, ordered by the first ncmp (1..3) streams. out[] must not
// alias in[]. Returns a cudaError_t.
extern "C" int lsd_merge_pass(const void* const* in, void* const* out, int ns,
                              long long n, long long run_len, int ncmp,
                              void* stream) {
  if (ns < 1 || ns > kMaxStreams || ncmp < 1 || ncmp > 3 || ncmp > ns ||
      run_len < 1 || n % run_len != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  Streams s{};
  for (int t = 0; t < ns; ++t) {
    s.in[t] = static_cast<const uint32_t*>(in[t]);
    s.out[t] = static_cast<uint32_t*>(out[t]);
  }
  const long long nruns = n / run_len;
  const long long blocks_per_run = (run_len + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(nruns * blocks_per_run);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (ncmp) {
    case 1:
      merge_pass<1><<<blocks, kThreads, 0, st>>>(s, ns, run_len, nruns,
                                                 blocks_per_run);
      break;
    case 2:
      merge_pass<2><<<blocks, kThreads, 0, st>>>(s, ns, run_len, nruns,
                                                 blocks_per_run);
      break;
    default:
      merge_pass<3><<<blocks, kThreads, 0, st>>>(s, ns, run_len, nruns,
                                                 blocks_per_run);
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
