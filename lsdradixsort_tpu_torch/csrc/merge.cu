// One 8-way merge pass for Hopper (sm_90a).
//
// Replaces the Pallas kernel merge_pass_multi (_merge_kernel_multi /
// _merge_kernel_multi_pipe) of lsdradixsort_tpu/kernels/merge.py. The
// input is n rows in sorted runs of run_len; every group of up to 8
// consecutive runs becomes one sorted run. Rows are ordered by the key,
// then (ncmp = 2) by payload 0, both unsigned, then by run, then by
// position in the run: a stable merge. Every stream moves with its row.
//
// Design: a row's output position is known without merging. The row x at
// position p of run i lands at group_base + p + sum over the other runs j
// of rank_j(x), the number of rows of run j ordered before x (rows equal
// to x count when j < i). Each thread owns one input row and finds its
// ranks by binary search. A block owns 256 consecutive rows of one run, so
// their ranks in run j lie between the ranks of its first and last row:
// 16 threads find those bounds first, and each row then searches only
// that window. Every stream is then scattered to the row's position.
//
// What bounds it on the H100: the searches are dependent loads, 7 windows
// of about log2(window) steps per row, served mostly from L1/L2; the
// stream traffic itself is one read and one scattered write per word. The
// pass has no buffer capacity, so no key distribution can overflow it
// (the TPU kernel's skew fallback has nothing to guard here). Merge-path
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

// Is row y ordered before row x? Rows equal on the compared words count
// as before when `or_equal` (y's run precedes x's run).
template <int NC>
__device__ __forceinline__ bool before(uint32_t yk, uint32_t yv, uint32_t xk,
                                       uint32_t xv, bool or_equal) {
  if (yk != xk) return yk < xk;
  if (NC == 2 && yv != xv) return yv < xv;
  return or_equal;
}

// First position q in [lo, hi) of the run at `base` whose row is not
// ordered before x (hi if every row is): the rank of x in that run.
template <int NC>
__device__ long long rank_in_run(const uint32_t* __restrict__ keys,
                                 const uint32_t* __restrict__ v0,
                                 long long base, long long lo, long long hi,
                                 uint32_t xk, uint32_t xv, bool or_equal) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const uint32_t yk = keys[base + mid];
    const uint32_t yv = NC == 2 ? v0[base + mid] : 0u;
    if (before<NC>(yk, yv, xk, xv, or_equal)) {
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
  const uint32_t* keys = s.in[0];
  const uint32_t* v0 = NC == 2 ? s.in[1] : nullptr;
  const long long ibase = run * run_len;

  if (threadIdx.x < 2 * kWay) {
    const int j = threadIdx.x >> 1;
    const bool last = threadIdx.x & 1;
    if (j < nr && j != i) {
      const long long q = ibase + (last ? p1 - 1 : p0);
      const uint32_t xk = keys[q];
      const uint32_t xv = NC == 2 ? v0[q] : 0u;
      const long long r = rank_in_run<NC>(keys, v0, (first_run + j) * run_len,
                                          0, run_len, xk, xv, j < i);
      (last ? win_hi : win_lo)[j] = r;
    }
  }
  __syncthreads();

  const long long p = p0 + threadIdx.x;
  if (p >= p1) return;
  const long long q = ibase + p;
  const uint32_t xk = keys[q];
  const uint32_t xv = NC == 2 ? v0[q] : 0u;
  long long pos = first_run * run_len + p;
  for (int j = 0; j < nr; ++j) {
    if (j == i) continue;
    pos += rank_in_run<NC>(keys, v0, (first_run + j) * run_len, win_lo[j],
                           win_hi[j], xk, xv, j < i);
  }
  for (int t = 0; t < ns; ++t) s.out[t][pos] = s.in[t][q];
}

}  // namespace

// One merge pass over `ns` (1..8) u32 streams of n rows, stream 0 the key:
// groups of 8 sorted runs of run_len (n a multiple of run_len) become
// sorted runs, ordered by the first ncmp (1 or 2) streams. out[] must not
// alias in[]. Returns a cudaError_t.
extern "C" int lsd_merge_pass(const void* const* in, void* const* out, int ns,
                              long long n, long long run_len, int ncmp,
                              void* stream) {
  if (ns < 1 || ns > kMaxStreams || ncmp < 1 || ncmp > 2 || ncmp > ns ||
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
  if (ncmp == 1) {
    merge_pass<1><<<blocks, kThreads, 0, st>>>(s, ns, run_len, nruns,
                                               blocks_per_run);
  } else {
    merge_pass<2><<<blocks, kThreads, 0, st>>>(s, ns, run_len, nruns,
                                               blocks_per_run);
  }
  return cudaGetLastError();
}
