// Exclusive prefix sums for Hopper (sm_90a).
//
// Replaces the Pallas kernels of lsdradixsort_tpu/kernels/scan.py:
// exclusive_scan (_scan_kernel), exclusive_scan_hierarchical
// (_block_totals_kernel, _scan_fixup_kernel) and block_prefix_sums
// (_block_scan_kernel). Every add is a u32 add mod 2^32; an i32 input is
// the same bits.
//
// The TPU sweeps its grid in order and threads one carry through it
// (_scan_kernel, scan.py:97-106). CUDA CTAs run in no fixed order, so:
//
//  * scan_lookback, exclusive_scan: Merrill & Garland's single-pass scan
//    with decoupled look-back ("Single-pass Parallel Prefix Scan with
//    Decoupled Look-back", NVIDIA, 2016). Each CTA takes its index from an
//    atomic ticket, not from blockIdx, so every CTA before it has started
//    and the look-back cannot wait on one that never runs. It loads kSub
//    tiles of kTile = 4096 words (16-byte loads where aligned), scans each
//    in shared memory (scan_tile), publishes their aggregate in its status
//    word, then one warp reads the status words of the 32 preceding CTAs
//    at a time, backing off while one is not ready: it sums aggregates
//    back to the nearest CTA that has published its inclusive prefix,
//    publishes its own inclusive prefix, and the CTA writes its words plus
//    that exclusive prefix. The status words and the ticket (the
//    look-back of single_pass.cuh, shared with compaction.cu) live in
//    scratch that the caller keeps for the stream: the last CTA to finish
//    clears them for the next launch, so a scan is one launch and no
//    memset: one read and one write of the data, against the TPU's one
//    sweep.
//  * seg_scan: a CTA scans kTile words at a time in shared memory
//    (16 a thread, warp shuffles across a warp, one warp across the
//    warps), exclusive within segments of `seg` words: several whole
//    segments in one tile when seg < kTile, or one segment a CTA, looping
//    over its tiles with a running carry, when seg >= kTile. It can write
//    each segment's total. Alone it is block_prefix_sums (the reference's
//    BlockPrefixSumKernel with its carry-out of block totals,
//    LSDRadixSort.cu:180-207).
//  * seg_scan_regs: the segmented scan for short power-of-two segments
//    (seg <= kRegMaxSeg), the composed sort's histogram rows of 2^r
//    words. No shared memory and no barrier: a lane loads 4 consecutive
//    words with one 16-byte load; a lane scans a segment of seg <= 4
//    words alone, seg / 4 lanes scan one of up to 128 words with
//    __shfl_up_sync of that width, and a warp scans one of 256 words in
//    two 16-byte loads a lane, carrying the total from one to the next.
//    The last lane of a segment writes its total; stores are 16 bytes.
//    lsd_seg_scan takes it when x and out are 16-byte aligned and the
//    segments tile n (seg <= 4: n's last n % 4 words go to seg_scan);
//    otherwise, and for longer segments (the reference's 2^13 block),
//    seg_scan.
//  * scan_rounds, exclusive_scan_hierarchical: the reference's
//    hierarchical decomposition (GPUPrefixSum, cu:286-302; the JAX
//    _block_totals_kernel, a scan of the totals, _scan_fixup_kernel) --
//    block totals, a scan of the totals, each block scanned plus its
//    offset -- in one cooperative launch that keeps each block on chip
//    between the first step and the last. A persistent grid (the CTAs
//    the card holds at once, one an SM) walks the data in rounds; in
//    each, a CTA takes its block of kHierBlock words (128 KB) from shared
//    memory into registers, where its copy (cp.async) landed during the
//    round before, starts the copy of its next block, scans this one,
//    publishes its total and waits at a grid barrier (cooperative
//    groups); then it sums the totals before it, adds the carry of the
//    earlier rounds, and stores. Every round pays the barrier and the
//    exchange of totals whatever its size, so the block is the largest
//    that the registers hold without spills (16 vectors a thread; 18 or
//    20 spill): 32 rounds at 2^27 words. No recursion, no second pass: one
//    read and one write of the data, against GPUPrefixSum's two of each.
//    It stays a scheme of its own beside exclusive_scan's look-back (the
//    bench CLI's scan/carry and scan/hier records compare the two).
//
// What bounds them on the H100: device-memory bytes (4 bytes a word each
// time it is read or written); a word costs two adds. exclusive_scan at
// small sizes (the composed sort's 32 Ki - 4 Mi word histograms) is bound
// by launches and host calls: hence one launch from one C call, with no
// memset and no allocation but the output. The histogram rows' scans
// (64 Ki - 4 Mi words) likewise: one C call, one launch of
// seg_scan_regs, whose one DRAM round trip a lane takes no barrier to
// wait on.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "single_pass.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// Shared-memory index with one pad word after every 32: a thread's 16
// consecutive words then sit in banks no other lane of its warp uses.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Exclusive scan, in place, of the kTile words in s (padded layout).
// Returns the tile's total to every thread.
__device__ uint32_t scan_tile(uint32_t* s, uint32_t* wsum) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  uint32_t v[kItems];
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = s[pad(t * kItems + i)];
    sum += v[i];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const uint32_t x = lane < kWarps ? wsum[lane] : 0u;
    uint32_t xi = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, xi, o);
      if (lane >= o) xi += y;
    }
    if (lane < kWarps) wsum[lane] = xi - x;
    if (lane == kWarps - 1) wsum[kWarps] = xi;
  }
  __syncthreads();
  uint32_t run = wsum[w] + incl - sum;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    s[pad(t * kItems + i)] = run;
    run += v[i];
  }
  const uint32_t total = wsum[kWarps];
  __syncthreads();
  return total;
}

// Exclusive scan of each segment of `seg` words of x (the last may be
// short); totals[k] gets segment k's sum when totals is given. A CTA
// covers `span` words: span == seg when seg >= kTile, else a whole number
// of segments <= kTile.
// x may be out (each CTA reads a tile before it writes it).
__global__ void __launch_bounds__(kThreads)
seg_scan(const uint32_t* x, uint32_t* out, uint32_t* totals, long long n,
         long long seg, long long span) {
  __shared__ uint32_t s[kTile + kTile / 32];
  __shared__ uint32_t wsum[kWarps + 1];
  const long long base = static_cast<long long>(blockIdx.x) * span;
  const long long end = min(n, base + span);
  uint32_t carry = 0;
  for (long long c0 = base; c0 < end; c0 += kTile) {
    const int len = static_cast<int>(min(static_cast<long long>(kTile),
                                         end - c0));
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      s[pad(i)] = i < len ? x[c0 + i] : 0u;
    }
    __syncthreads();
    const uint32_t total = scan_tile(s, wsum);
    if (seg >= kTile) {
      for (int i = threadIdx.x; i < len; i += kThreads) {
        out[c0 + i] = s[pad(i)] + carry;
      }
      carry += total;
    } else {
      // c0 == base: the CTA's segments all lie in this one tile
      const int sg = static_cast<int>(seg);
      const long long k0 = c0 / sg;
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const int st = i - i % sg;
        out[c0 + i] = s[pad(i)] - s[pad(st)];
      }
      if (totals) {
        for (int k = threadIdx.x; k * sg < len; k += kThreads) {
          const int st = k * sg, en = min(st + sg, len);
          totals[k0 + k] = (en < kTile ? s[pad(en)] : total) - s[pad(st)];
        }
      }
    }
    __syncthreads();
  }
  if (seg >= kTile && totals && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Longest segment seg_scan_regs takes: a warp, 2 loads of 16 bytes a lane.
constexpr int kRegMaxSeg = 256;
constexpr int kRegThreads = 128;

// Exclusive scan of each segment of seg words (a power of two <= 128 when
// K == 1, 256 when K == 2) of the nvec 16-byte vectors of x, with
// each segment's total in totals (when given). A warp covers 32 K
// vectors: lane l holds vectors base + 32 k + l, k < K. nvec is a whole
// number of segments, or of vectors when seg < 4. x may be out (a lane
// writes only the vectors it has read).
template <int K>
__global__ void __launch_bounds__(kRegThreads)
seg_scan_regs(const uint4* x, uint4* out, uint32_t* totals, long long nvec,
              int seg) {
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kRegThreads + threadIdx.x -
       lane) * K;
  uint4 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long p = base + 32 * k + lane;
    v[k] = p < nvec ? x[p] : make_uint4(0u, 0u, 0u, 0u);
  }
  if (seg < 4) {
    // K == 1: each lane's 4 words hold 4 / seg whole segments
    const long long p = base + lane;
    if (p >= nvec) return;
    const uint32_t w[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
    uint32_t e[4];
    uint32_t run = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((i & (seg - 1)) == 0) run = 0;
      e[i] = run;
      run += w[i];
      if (totals && (i & (seg - 1)) == seg - 1) totals[(4 * p + i) / seg] = run;
    }
    out[p] = make_uint4(e[0], e[1], e[2], e[3]);
    return;
  }
  // seg / 4 lanes a segment (all 32 when K > 1)
  const int width = K > 1 ? 32 : seg / 4;
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t s1 = v[k].x, s2 = s1 + v[k].y, s3 = s2 + v[k].z,
                   sum = s3 + v[k].w;
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      if (o < width) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o, width);
        if ((lane & (width - 1)) >= o) incl += y;
      }
    }
    const uint32_t excl = carry + incl - sum;
    const long long p = base + 32 * k + lane;
    if (p < nvec) {
      out[p] = make_uint4(excl, excl + s1, excl + s2, excl + s3);
      if (K == 1 && totals && (lane & (width - 1)) == width - 1) {
        totals[p / width] = incl;
      }
    }
    if (K > 1) carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (K > 1 && totals && lane == 31 && base < nvec) {
    totals[base / (32 * K)] = carry;
  }
}

template <int K>
cudaError_t launch_seg_scan_regs(const uint32_t* x, uint32_t* out,
                                 uint32_t* totals, long long nvec, int seg,
                                 cudaStream_t st) {
  const long long per_cta = static_cast<long long>(kRegThreads) * K;
  const long long grid = (nvec + per_cta - 1) / per_cta;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  seg_scan_regs<K><<<static_cast<unsigned>(grid), kRegThreads, 0, st>>>(
      reinterpret_cast<const uint4*>(x), reinterpret_cast<uint4*>(out),
      totals, nvec, seg);
  return cudaGetLastError();
}

// Words a CTA of the single-pass scan covers: kSub scan tiles.
constexpr int kSub = 2;
constexpr int kLbTile = kSub * kTile;

// Words [c0, c0 + len) of x into the padded tile s: 16-byte loads when the
// tile is whole and aligned, else one word at a time (zeros past len).
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ x,
                                          long long c0, int len, uint32_t* s) {
  if (len == kTile && (reinterpret_cast<uintptr_t>(x + c0) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(x + c0);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int i = k * kThreads + threadIdx.x;
      const uint4 w = v[i];
      s[pad(4 * i)] = w.x;
      s[pad(4 * i + 1)] = w.y;
      s[pad(4 * i + 2)] = w.z;
      s[pad(4 * i + 3)] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + threadIdx.x;
      s[pad(i)] = i < len ? x[c0 + i] : 0u;
    }
  }
}

// out[c0, c0 + len) = the padded tile s plus add, as load_tile reads.
__device__ __forceinline__ void store_tile(uint32_t* __restrict__ out,
                                           long long c0, int len,
                                           const uint32_t* s, uint32_t add) {
  if (len == kTile && (reinterpret_cast<uintptr_t>(out + c0) & 15) == 0) {
    uint4* v = reinterpret_cast<uint4*>(out + c0);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int i = k * kThreads + threadIdx.x;
      v[i] = make_uint4(s[pad(4 * i)] + add, s[pad(4 * i + 1)] + add,
                        s[pad(4 * i + 2)] + add, s[pad(4 * i + 3)] + add);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + threadIdx.x;
      if (i < len) out[c0 + i] = s[pad(i)] + add;
    }
  }
}

// One CTA of the single-pass scan: kSub scan tiles. status: the look-back
// scratch of single_pass.cuh, all zero at launch and left all zero.
__global__ void __launch_bounds__(kThreads)
scan_lookback(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              unsigned long long* status, long long n) {
  __shared__ uint32_t s[kSub][kTile + kTile / 32];
  __shared__ uint32_t wsum[kWarps + 1];
  __shared__ long long s_tile;
  __shared__ uint32_t s_excl;
  __shared__ bool s_last;
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  if (threadIdx.x == 0) s_tile = take_ticket(status);
  __syncthreads();
  const long long tile = s_tile;
  long long c0[kSub];
  int len[kSub];
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    c0[u] = tile * kLbTile + u * kTile;
    const long long rest = n - c0[u];
    len[u] = static_cast<int>(rest < 0 ? 0 : rest < kTile ? rest : kTile);
    load_tile(x, c0[u], len[u], s[u]);
  }
  __syncthreads();
  uint32_t sub_total[kSub];
  uint32_t total = 0;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    sub_total[u] = scan_tile(s[u], wsum);
    total += sub_total[u];
  }
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) publish_aggregate(status, tile, total);
    const uint32_t excl = walk_back(status, tile, total);
    if (threadIdx.x == 0) {
      s_excl = excl;
      s_last = finish_tile(status, tiles);
    }
  }
  __syncthreads();
  uint32_t add = s_excl;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    store_tile(out, c0[u], len[u], s[u], add);
    add += sub_total[u];
  }
  if (s_last) clear_status(status, tiles);
}

// --- exclusive_scan_hierarchical: one cooperative launch ------------------

// A CTA of scan_rounds: kHierThreads threads, each holding kHierChunks
// 16-byte vectors of a round's block in registers; vector c * kHierThreads
// + t of the block is thread t's c-th, so a warp's loads and stores are
// coalesced and its shared-memory reads hit 32 banks apart. A thread
// copies into and reads out of its own slots of the one shared-memory
// buffer only, so the next round's copy can land there as soon as the
// thread has read this round's.
constexpr int kHierThreads = 512;
constexpr int kHierWarps = kHierThreads / 32;
constexpr int kHierChunks = 16;
constexpr int kHierBatch = 8;  // chunks warp-scanned together
constexpr int kHierBlock = kHierChunks * kHierThreads * 4;  // words a round
constexpr size_t kHierSmem = kHierBlock * sizeof(uint32_t);  // 128 KB
static_assert(kHierChunks % kHierBatch == 0, "whole batches");

// Start this thread's copies of the block at word `base` of x into its
// slots of buf: 16 bytes a vector where x is aligned and the vector lies
// wholly before n, else word by word; words at or past n are not copied
// (scan_rounds masks them).
__device__ __forceinline__ void hier_load(const uint32_t* __restrict__ x,
                                          long long n, long long base,
                                          bool aligned, uint4* buf) {
#pragma unroll
  for (int c = 0; c < kHierChunks; ++c) {
    const int v = c * kHierThreads + threadIdx.x;
    const long long w0 = base + 4LL * v;
    if (aligned && w0 + 4 <= n) {
      cp_async16(buf + v, x + w0);
    } else {
      for (int i = 0; i < 4; ++i) {
        if (w0 + i < n) cp_async4(reinterpret_cast<uint32_t*>(buf + v) + i,
                                  x + w0 + i);
      }
    }
  }
  cp_async_commit();
}

// Exclusive scan of x into out, the reference's hierarchical way in one
// launch: a persistent grid of G CTAs (all resident: a cooperative launch)
// walks the data in `rounds` rounds of G blocks of kHierBlock words. In
// round k, CTA b takes block k * G + b into registers (its copy into
// shared memory started during round k - 1), starts the copy of its next
// block, scans this one, publishes its total, and waits at the grid
// barrier; then it sums the totals of the CTAs before it in the round,
// adds that and the carry of the earlier rounds (the same in every CTA),
// and stores its block. Each word is read and written once. totals: 2 * G
// words of scratch (one set a round parity: a round's totals are read
// before the next barrier, and the next round of the same parity writes
// them only after it).
__global__ void __launch_bounds__(kHierThreads, 1)
scan_rounds(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            uint32_t* totals, long long n, long long rounds) {
  extern __shared__ uint4 hbuf[];
  __shared__ uint32_t wsum[kHierChunks][kHierWarps];
  __shared__ uint32_t ctot[kHierChunks];
  __shared__ uint32_t red[kHierWarps][2];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long G = gridDim.x, b = blockIdx.x;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  uint32_t carry = 0;
  hier_load(x, n, b * kHierBlock, aligned, hbuf);
  for (long long k = 0; k < rounds; ++k) {
    const long long base = (k * G + b) * kHierBlock;
    cp_async_wait_all();  // this thread's slots: no barrier needed
    // each vector as its inclusive prefix (a, a + b, a + b + c, sum);
    // words at or past n read as 0
    uint4 v[kHierChunks];
#pragma unroll
    for (int c = 0; c < kHierChunks; ++c) {
      uint4 q = hbuf[c * kHierThreads + t];
      const long long w0 = base + 4LL * (c * kHierThreads + t);
      if (w0 + 4 > n) {
        if (w0 >= n) q.x = 0;
        if (w0 + 1 >= n) q.y = 0;
        if (w0 + 2 >= n) q.z = 0;
        q.w = 0;
      }
      q.y += q.x;
      q.z += q.y;
      q.w += q.z;
      v[c] = q;
    }
    // the next block: its copy runs across this round's barrier (the
    // prefixes above have read this thread's slots)
    if (k + 1 < rounds) {
      hier_load(x, n, base + G * kHierBlock, aligned, hbuf);
    }
    // warp scans of each chunk, a batch at a time; each vector becomes
    // its exclusive prefix within the warp; lane 31 keeps the warp's sum
#pragma unroll
    for (int c0 = 0; c0 < kHierChunks; c0 += kHierBatch) {
      uint32_t incl[kHierBatch];
#pragma unroll
      for (int i = 0; i < kHierBatch; ++i) incl[i] = v[c0 + i].w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < kHierBatch; ++i) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, incl[i], o);
          if (lane >= o) incl[i] += y;
        }
      }
#pragma unroll
      for (int i = 0; i < kHierBatch; ++i) {
        uint4& q = v[c0 + i];
        const uint32_t e = incl[i] - q.w;
        q = make_uint4(e, e + q.x, e + q.y, e + q.z);
        if (lane == 31) wsum[c0 + i][w] = incl[i];
      }
    }
    __syncthreads();
    // each chunk's warp sums scanned by one warp
    for (int c = w; c < kHierChunks; c += kHierWarps) {
      const uint32_t s = lane < kHierWarps ? wsum[c][lane] : 0u;
      uint32_t si = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, si, o);
        if (lane >= o) si += y;
      }
      if (lane < kHierWarps) wsum[c][lane] = si - s;
      if (lane == kHierWarps - 1) ctot[c] = si;
    }
    __syncthreads();
    uint32_t total = 0;
#pragma unroll
    for (int c = 0; c < kHierChunks; ++c) {
      const uint32_t add = total + wsum[c][w];
      v[c] = make_uint4(v[c].x + add, v[c].y + add, v[c].z + add,
                        v[c].w + add);
      total += ctot[c];
    }
    uint32_t* round_totals = totals + (k & 1) * G;
    if (t == 0) round_totals[b] = total;
    grid.sync();
    // the CTAs before this one in the round, and the round's total
    uint32_t before = 0, all = 0;
    if (t < G) {
      all = __ldcg(round_totals + t);
      before = t < b ? all : 0u;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, o);
      all += __shfl_xor_sync(0xffffffffu, all, o);
    }
    if (lane == 0) {
      red[w][0] = before;
      red[w][1] = all;
    }
    __syncthreads();
    uint32_t add = carry, round_total = 0;
#pragma unroll
    for (int i = 0; i < kHierWarps; ++i) {
      add += red[i][0];
      round_total += red[i][1];
    }
    carry += round_total;
#pragma unroll
    for (int c = 0; c < kHierChunks; ++c) {
      const int vi = c * kHierThreads + t;
      const long long w0 = base + 4LL * vi;
      const uint4 o = make_uint4(v[c].x + add, v[c].y + add, v[c].z + add,
                                 v[c].w + add);
      if (aligned && w0 + 4 <= n) {
        reinterpret_cast<uint4*>(out + base)[vi] = o;
      } else {
        const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
        for (int i = 0; i < 4; ++i) {
          if (w0 + i < n) out[w0 + i] = ow[i];
        }
      }
    }
  }
}

// CTAs of scan_rounds resident on `device` at once (the cooperative
// grid's ceiling), or 0 on an error; cached per device.
int hier_ctas(int device) {
  static int cache[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (cache[device] > 0) return cache[device];
  int sms = 0, per_sm = 0, coop = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) !=
          cudaSuccess ||
      !coop ||
      cudaFuncSetAttribute(scan_rounds,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kHierSmem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scan_rounds, kHierThreads, kHierSmem) != cudaSuccess) {
    return 0;
  }
  const int ctas = sms * per_sm;
  cache[device] = ctas < kHierThreads ? ctas : kHierThreads;
  return cache[device];
}

}  // namespace

// Words a scan tile holds.
extern "C" int lsd_scan_tile() { return kTile; }

// Words a CTA of exclusive_scan covers: it takes one status word for each,
// plus one for the ticket.
extern "C" int lsd_scan_lookback_words() { return kLbTile; }

// Exclusive scans of the segments of `seg` words of x into out, and their
// totals (one per segment) when totals is not null, on `device` (made
// current for the launch) and `stream`. seg >= 1; x may equal out. Short
// power-of-two segments of aligned words take seg_scan_regs, the rest
// seg_scan. Returns a cudaError_t.
extern "C" int lsd_seg_scan(const void* x, void* out, void* totals,
                            long long n, long long seg, int device,
                            void* stream) {
  if (seg < 1 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int prev;
  cudaError_t err = enter_device(device, &prev);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* os = static_cast<uint32_t*>(out);
  uint32_t* ts = static_cast<uint32_t*>(totals);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  // words seg_scan_regs covers: whole segments in whole 16-byte vectors
  long long head = 0;
  if (aligned && (seg & (seg - 1)) == 0 && seg <= kRegMaxSeg &&
      (seg < 4 || n % seg == 0)) {
    head = n & ~3LL;
  }
  if (head > 0) {
    const int sg = static_cast<int>(seg);
    const long long nvec = head / 4;
    err = sg <= 128 ? launch_seg_scan_regs<1>(xs, os, ts, nvec, sg, st)
                    : launch_seg_scan_regs<2>(xs, os, ts, nvec, sg, st);
  }
  if (err == cudaSuccess && head < n) {
    // the rest: every segment, or the last n % 4 words of short ones
    const long long rest = n - head;
    const long long span = seg >= kTile ? seg : kTile / seg * seg;
    const long long grid = (rest + span - 1) / span;
    if (grid > 0x7fffffffLL) {
      err = cudaErrorInvalidValue;
    } else {
      seg_scan<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
          xs + head, os + head, ts ? ts + head / seg : nullptr, rest, seg,
          span);
      err = cudaGetLastError();
    }
  }
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// Exclusive scan of the n words of x into out in one pass (scan_lookback),
// on `device` (made current for the launch) and `stream`. status is
// 64-bit scratch of at least ceil(n / lsd_scan_lookback_words()) + 2
// words, all zero, which the launch leaves all zero; launches that share
// it must be ordered (one stream). x must not alias out. Returns a
// cudaError_t.
extern "C" int lsd_exclusive_scan(const void* x, void* out, void* status,
                                  long long n, int device, void* stream) {
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  if (n < 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int prev;
  cudaError_t err = enter_device(device, &prev);
  if (err != cudaSuccess) return err;
  scan_lookback<<<static_cast<unsigned>(tiles), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), n);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// Words a CTA of exclusive_scan_hierarchical scans a round.
extern "C" int lsd_scan_hier_block() { return kHierBlock; }

// CTAs of exclusive_scan_hierarchical's grid on `device` when the data
// fills them (the cooperative ceiling: SMs x CTAs an SM), 0 on an error.
extern "C" int lsd_scan_hier_ctas(int device) { return hier_ctas(device); }

// Exclusive scan of the n words of x into out, the reference's
// hierarchical way (GPUPrefixSum, cu:286-302) in one cooperative launch of
// scan_rounds on `device` (made current) and `stream`: G = min(the
// resident CTAs, ceil(n / block)) CTAs, ceil(n / (G * block)) rounds.
// scratch: 2 * lsd_scan_hier_ctas(device) u32 words. x must not alias
// out. Returns a cudaError_t.
extern "C" int lsd_scan_hierarchical(const void* x, void* out, void* scratch,
                                     long long n, int device, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int prev;
  cudaError_t err = enter_device(device, &prev);
  if (err != cudaSuccess) return err;
  const long long ctas = hier_ctas(device);
  if (ctas <= 0) {
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaErrorCooperativeLaunchTooLarge;
  } else {
    const long long blocks = (n + kHierBlock - 1) / kHierBlock;
    const long long grid = blocks < ctas ? blocks : ctas;
    long long rounds = (blocks + grid - 1) / grid;
    const uint32_t* xs = static_cast<const uint32_t*>(x);
    uint32_t* os = static_cast<uint32_t*>(out);
    uint32_t* ts = static_cast<uint32_t*>(scratch);
    void* args[] = {&xs, &os, &ts, &n, &rounds};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(scan_rounds),
        dim3(static_cast<unsigned>(grid)), dim3(kHierThreads), args, kHierSmem,
        static_cast<cudaStream_t>(stream));
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return err;
}
