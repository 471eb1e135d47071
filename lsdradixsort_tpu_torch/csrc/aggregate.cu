// The reduction after the sort of a filtered GROUP BY SUM, for Hopper
// (sm_90a): ops/aggregate.py filtered_group_by_sum, from the sorted
// streams to the answer in one launch.
//
// Input: three u32 streams of n rows, sorted by (key, packed): the group
// key sk, the packed column sp ((rejected << 31) | position) and the value
// sv. A row is kept when sp < 2^31; its value counts as v = kept ? sv : 0.
// A kept row ends a run when it is the last row, or when the next row's
// key or kept flag differs. For the j-th run end e_j the launch writes
// keys_out[j] = sk[e_j] and sums_out[j] = S(e_j) - S(e_{j-1}) mod 2^32,
// where S is the running sum of v (S(e_{-1}) = 0), and count = the number
// of run ends. Rows from count on are left as they were. This is the JAX
// package's sequence (a running sum, the run-end flags, a compaction of
// the run ends, the differences of their sums) for any input, sorted or
// not, with none of its full-length intermediates.
//
// One pass with decoupled look-back (single_pass.cuh: the ticket, the
// relaxed 64-bit status words, the clearing by the last CTA). A CTA takes
// a tile of kTile = kThreads * kRows rows. Warp w holds rows
// [w * 32 * kRows, (w + 1) * 32 * kRows) of it, in kRows / 4 groups of 128
// rows; lane l holds rows 4l .. 4l + 3 of each group, loaded 16 bytes at a
// time (coalesced; row by row where a stream is not 16-byte aligned or the
// tile is cut by n). The row after a lane's last row comes from the next
// lane by a shuffle, from lane 0 of the next group, or, for the warp's
// last row, from device memory.
//
// What a tile publishes is a segmented sum, whose run ends are the
// segment boundaries: the pair (c, s) of its count of run ends and the
// sum of v after its last run end (all of the tile's v when c = 0). Pairs
// combine in order as (c1, s1) . (c2, s2) = (c1 + c2, c2 ? s2 : s1 + s2).
// A status word holds a pair in 64 bits: 0 while not ready; an aggregate
// as (c + 1) << 32 | s (c <= kTile, so the word is nonzero and bit 63
// clear); an inclusive prefix as 1 << 63 | c << 32 | s (c <= n < 2^31).
// The look-back warp sums the counts back to the nearest inclusive
// prefix, and the sums only back to the nearest tile with a run end or
// that prefix: the run that the tile's first run end closes began after
// it. So each run's sum is known at its end, in the pass, and the
// differences cost nothing more; a second launch over the count is not
// needed.
//
// Warps without a run end (all but a few in a query's sort of a few
// groups) only add their values. A warp with one scans its lanes' pairs
// with shuffles, group by group, and keeps each lane's exclusive pair;
// after the look-back, the lanes with run ends write them.
//
// What bounds it on the H100: reading the three streams once, 12 bytes a
// row, through registers (no row is staged in shared memory: each is
// used once, where it is loaded); the run ends' writes are 8 bytes each.
// So a CTA's loads are all issued before it uses any, and the more bytes
// an SM has in flight the closer it comes: 32 rows a thread (96 KB a
// tile) at two CTAs an SM, the launch bound holding a thread to 128
// registers. At 1.8e8 rows (H100 80GB HBM3, 700 W) that took 0.86 ms,
// against 1.12 at 32 rows and one CTA an SM (144 registers), 1.00 at 16
// rows and three, 0.98 at 16 and four (spilling) and 0.87 at 32 rows and
// 512 threads; the three streams' read alone takes 0.70.
#include <cstdint>
#include <cuda_runtime.h>

#include "single_pass.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows a thread
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kRows / 4;
constexpr int kWarpRows = 32 * kRows;
constexpr int kTile = kThreads * kRows;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kInclusive = 1ull << 63;

// A segmented sum: the count of run ends, and the sum after the last.
struct Runs {
  uint32_t c, s;
};

__device__ __forceinline__ Runs combine(Runs a, Runs b) {
  return {a.c + b.c, b.c ? b.s : a.s + b.s};
}

__device__ __forceinline__ Runs shfl_up(Runs x, int o) {
  return {__shfl_up_sync(kFull, x.c, o), __shfl_up_sync(kFull, x.s, o)};
}

// This thread's kRows rows of x in the tile at r0 of len rows (row
// w * kWarpRows + 128 * g + 4 * lane + b is v[4 * g + b]); rows past len
// read `fill`.
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ x,
                                          long long r0, int len, bool vec,
                                          uint32_t fill,
                                          uint32_t (&v)[kRows]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const uint32_t* p = x + r0 + w * kWarpRows;
  if (vec) {
    const uint4* q = reinterpret_cast<const uint4*>(p) + lane;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint4 u = __ldcs(q + 32 * g);
      v[4 * g] = u.x, v[4 * g + 1] = u.y, v[4 * g + 2] = u.z;
      v[4 * g + 3] = u.w;
    }
  } else {
    const int row0 = w * kWarpRows + 4 * lane;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int row = row0 + 128 * g + b;
        v[4 * g + b] = row < len ? p[row - w * kWarpRows] : fill;
      }
    }
  }
}

// One whole warp, after the tile's pair `agg` is published: the pair of
// every row before the tile, to every lane; then it publishes the tile's
// inclusive pair. Lane l reads the status word of tile j - l, 32 tiles at
// a time, as single_pass.cuh's walk_back does.
__device__ Runs walk_runs(unsigned long long* status, long long tile,
                          Runs agg) {
  const int lane = threadIdx.x & 31;
  unsigned long long* word = status + 2;
  Runs excl{0u, 0u};
  bool closed = false;  // the sums have met a run end or a prefix
  for (long long j = tile - 1;; j -= 32) {
    const long long t = j - lane;
    unsigned long long w = t >= 0 ? load_status(word + t) : kInclusive;
    unsigned backoff = 32;
    while (__any_sync(kFull, w == 0)) {
      __nanosleep(backoff);
      if (backoff < 1024) backoff <<= 1;
      if (w == 0) w = load_status(word + t);
    }
    const bool incl = (w >> 63) != 0;
    const unsigned pmask = __ballot_sync(kFull, incl);
    const int first = pmask ? __ffs(pmask) - 1 : 32;
    const uint32_t hi = static_cast<uint32_t>(w >> 32);
    const uint32_t c = lane > first ? 0u : incl ? hi & 0x7fffffffu : hi - 1u;
    const unsigned emask = __ballot_sync(kFull, lane <= first && (incl || c));
    const int stop = emask ? __ffs(emask) - 1 : 32;
    const uint32_t s =
        !closed && lane <= stop ? static_cast<uint32_t>(w) : 0u;
    excl.c += __reduce_add_sync(kFull, c);
    excl.s += __reduce_add_sync(kFull, s);
    closed = closed || emask != 0;
    if (pmask) break;
  }
  const Runs inc = combine(excl, agg);
  if (lane == 0) {
    store_status(word + tile, kInclusive |
                                  static_cast<unsigned long long>(inc.c) << 32 |
                                  inc.s);
  }
  return excl;
}

// One CTA: the tile of rows [tile * kTile, tile * kTile + kTile), cut at n.
__global__ void __launch_bounds__(kThreads, 2)
filtered_runs(const uint32_t* __restrict__ sk, const uint32_t* __restrict__ sp,
              const uint32_t* __restrict__ sv, long long n,
              uint32_t* __restrict__ keys_out, uint32_t* __restrict__ sums_out,
              uint32_t* count, unsigned long long* status) {
  __shared__ Runs wagg[kWarps];
  __shared__ Runs s_excl;
  __shared__ long long s_tile;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long tiles = (n + kTile - 1) / kTile;
  if (threadIdx.x == 0) s_tile = take_ticket(status);
  __syncthreads();
  const long long tile = s_tile;
  const long long r0 = tile * kTile;
  const int len = static_cast<int>(n - r0 < kTile ? n - r0 : kTile);
  const bool vec =
      len == kTile &&
      ((reinterpret_cast<uintptr_t>(sk) | reinterpret_cast<uintptr_t>(sp) |
        reinterpret_cast<uintptr_t>(sv)) & 15) == 0;

  // the row after the warp's last, for lane 31
  const long long after = r0 + (w + 1) * kWarpRows;
  uint32_t key_after = 0, packed_after = 0;
  if (lane == 31 && after < n) {
    key_after = sk[after];
    packed_after = sp[after];
  }
  uint32_t key[kRows], packed[kRows], val[kRows];
  load_rows(sk, r0, len, vec, 0u, key);
  load_rows(sp, r0, len, vec, kFull, packed);  // rows past n: rejected
  load_rows(sv, r0, len, vec, 0u, val);

  // each row's value (0 where rejected) and whether it ends a run; each
  // group's pair (c, s) of this lane's 4 rows
  const long long row0 = r0 + w * kWarpRows + 4 * lane;
  uint32_t ends = 0;  // bit 4 g + b: row 4 g + b ends a run
  Runs part[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    uint32_t knext = __shfl_down_sync(kFull, key[4 * g], 1);
    uint32_t pnext = __shfl_down_sync(kFull, packed[4 * g], 1);
    const uint32_t kg = g + 1 < kGroups
                            ? __shfl_sync(kFull, key[(4 * g + 4) % kRows], 0)
                            : key_after;
    const uint32_t pg =
        g + 1 < kGroups ? __shfl_sync(kFull, packed[(4 * g + 4) % kRows], 0)
                        : packed_after;
    if (lane == 31) knext = kg, pnext = pg;
    Runs p{0u, 0u};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * g + b;
      const uint32_t kn = b < 3 ? key[(i + 1) % kRows] : knext;
      const uint32_t pn = b < 3 ? packed[(i + 1) % kRows] : pnext;
      const bool kept = static_cast<int32_t>(packed[i]) >= 0;
      const bool end =
          kept && (row0 + 128 * g + b + 1 >= n || kn != key[i] ||
                   (static_cast<int32_t>(pn) >= 0) != kept);
      val[i] = kept ? val[i] : 0u;
      p.s += val[i];
      if (end) {
        ends |= 1u << i;
        ++p.c;
        p.s = 0;
      }
    }
    part[g] = p;
  }

  // the warp's pair; with a run end in the warp, each group's exclusive
  // pair of this lane within the warp (part[g] is replaced by it)
  const bool any_end = __any_sync(kFull, ends != 0);
  Runs wsum{0u, 0u};
  if (!any_end) {
    uint32_t s = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += part[g].s;
    wsum.s = __reduce_add_sync(kFull, s);
  } else {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      Runs inc = part[g];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const Runs y = shfl_up(inc, o);
        if (lane >= o) inc = combine(y, inc);
      }
      Runs ex = shfl_up(inc, 1);
      if (lane == 0) ex = Runs{0u, 0u};
      part[g] = combine(wsum, ex);
      wsum = combine(wsum, Runs{__shfl_sync(kFull, inc.c, 31),
                                __shfl_sync(kFull, inc.s, 31)});
    }
  }
  if (lane == 0) wagg[w] = wsum;
  __syncthreads();

  // the tile's pair, published; the pair of every row before it
  if (w == 0) {
    Runs agg{0u, 0u};
#pragma unroll
    for (int i = 0; i < kWarps; ++i) agg = combine(agg, wagg[i]);
    Runs excl{0u, 0u};
    if (tile == 0) {
      if (lane == 0) {
        store_status(status + 2, kInclusive |
                                     static_cast<unsigned long long>(agg.c)
                                         << 32 |
                                     agg.s);
      }
    } else {
      if (lane == 0) {
        store_status(status + 2 + tile,
                     static_cast<unsigned long long>(agg.c + 1) << 32 | agg.s);
      }
      excl = walk_runs(status, tile, agg);
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == tiles - 1) *count = excl.c + agg.c;
      s_last = finish_tile(status, tiles);
    }
  }
  __syncthreads();

  // the run ends: key and sum at the output row of each
  if (ends) {
    Runs before = s_excl;
#pragma unroll
    for (int i = 0; i < w; ++i) before = combine(before, wagg[i]);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (((ends >> (4 * g)) & 15u) == 0) continue;
      const Runs at = combine(before, part[g]);
      uint32_t j = at.c, s = at.s;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * g + b;
        s += val[i];
        if ((ends >> i) & 1u) {
          keys_out[j] = key[i];
          sums_out[j] = s;
          ++j;
          s = 0;
        }
      }
    }
  }
  if (s_last) clear_status(status, tiles);
}

}  // namespace

// The reduction of n sorted rows (keys, packed, values; u32 each, any
// alignment, 0 < n < 2^31) into the run ends' keys and sums, the first
// *count rows of keys_out and sums_out (see the header). status: the
// look-back scratch (single_pass.cuh) of at least n / kTile + 3 words, all
// zero, which the launch leaves all zero; launches that share it must be
// ordered (one stream). count: one u32 on the device. On `device` (made
// current for the launch) and `stream`. Returns a cudaError_t.
extern "C" int lsd_filtered_runs(const void* keys, const void* packed,
                                 const void* values, long long n,
                                 void* keys_out, void* sums_out, void* count,
                                 void* status, int device, void* stream) {
  if (n <= 0 || n >= (1LL << 31)) return cudaErrorInvalidValue;
  int prev;
  cudaError_t err = enter_device(device, &prev);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kTile - 1) / kTile;
  filtered_runs<<<static_cast<unsigned>(tiles), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(packed),
      static_cast<const uint32_t*>(values), n,
      static_cast<uint32_t*>(keys_out), static_cast<uint32_t*>(sums_out),
      static_cast<uint32_t*>(count),
      static_cast<unsigned long long*>(status));
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}
