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
//    that exclusive prefix. A status word is 64 bits, a 2-bit
//    flag (0 not ready, 1 aggregate, 2 inclusive prefix) above the 32-bit
//    value, written with st.release.gpu and read with ld.acquire.gpu. The
//    status words and the ticket live in scratch that the caller keeps
//    for the stream: the last CTA to finish clears them for the next
//    launch, so a scan is one launch and no memset: one read and one write
//    of the data, against the TPU's one sweep.
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
//  * add_offsets: out[p] += offsets[p / kTile] (AddBlockSumsKernel, cu:278).
//
// lsd_scan_propagate is the reference's GPUPrefixSum (cu:286-302) and the
// port of exclusive_scan_hierarchical: seg_scan with tile totals out, the
// same scan of the totals (recursively, in place, in scratch the caller
// gives), then add_offsets; it reads and writes the data twice.
//
// What bounds them on the H100: device-memory bytes (4 bytes a word each
// time it is read or written); a word costs two adds. exclusive_scan at
// small sizes (the composed sort's 32 Ki - 4 Mi word histograms) is bound
// by launches and host calls: hence one launch from one C call, with no
// memset and no allocation but the output. The histogram rows' scans
// (64 Ki - 4 Mi words) likewise: one C call, one launch of
// seg_scan_regs, whose one DRAM round trip a lane takes no barrier to
// wait on.
#include <cstdint>
#include <cuda_runtime.h>

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

// Makes `device` current; returns the device that was (to restore).
cudaError_t enter_device(int device, int* prev) {
  *prev = device;
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

// Status words of scan_lookback: flag << 32 | value.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
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

// One CTA of the single-pass scan: kSub scan tiles. status: the ticket
// and the count of CTAs done (each as a u32 in a 64-bit word), then one
// status word a CTA; all zero at launch, and all zero again when the last
// CTA is done (it clears them), so the scratch serves the next launch on
// the stream as it is.
__global__ void __launch_bounds__(kThreads)
scan_lookback(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              unsigned long long* status, long long n) {
  __shared__ uint32_t s[kSub][kTile + kTile / 32];
  __shared__ uint32_t wsum[kWarps + 1];
  __shared__ long long s_tile;
  __shared__ uint32_t s_excl;
  __shared__ bool s_last;
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(status);
  unsigned int* done = reinterpret_cast<unsigned int*>(status + 1);
  unsigned long long* word = status + 2;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
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
    const int lane = threadIdx.x;
    uint32_t excl = 0;
    if (tile == 0) {
      if (lane == 0) store_release(word, kPrefix | total);
    } else {
      if (lane == 0) store_release(word + tile, kAggregate | total);
      // walk back 32 CTAs at a time; lane l reads CTA j - l
      for (long long j = tile - 1;; j -= 32) {
        const long long t = j - lane;
        unsigned long long w = t >= 0 ? load_acquire(word + t) : kPrefix;
        unsigned backoff = 32;
        while (__any_sync(0xffffffffu, (w >> 32) == 0)) {
          __nanosleep(backoff);  // spare the status lines while they wait
          if (backoff < 1024) backoff <<= 1;
          if ((w >> 32) == 0) w = load_acquire(word + t);
        }
        const unsigned pmask = __ballot_sync(0xffffffffu, (w >> 32) == 2);
        const int first = pmask ? __ffs(pmask) - 1 : 32;
        uint32_t v = lane <= first ? static_cast<uint32_t>(w) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, o);
        }
        excl += v;
        if (pmask) break;
      }
      if (lane == 0) store_release(word + tile, kPrefix | (excl + total));
    }
    if (lane == 0) {
      s_excl = excl;
      // this CTA reads no status word any more; the last one clears them
      __threadfence();
      s_last = atomicAdd(done, 1u) == tiles - 1;
    }
  }
  __syncthreads();
  uint32_t add = s_excl;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    store_tile(out, c0[u], len[u], s[u], add);
    add += sub_total[u];
  }
  if (s_last) {
    for (long long t = threadIdx.x; t < tiles; t += kThreads) word[t] = 0;
    if (threadIdx.x == 0) {
      *ticket = 0;
      *done = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
add_offsets(uint32_t* out, const uint32_t* __restrict__ offsets, long long n) {
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - c0));
  const uint32_t add = offsets[blockIdx.x];
  for (int i = threadIdx.x; i < len; i += kThreads) out[c0 + i] += add;
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

cudaError_t scan_propagate(const uint32_t* x, uint32_t* out,
                           uint32_t* scratch, long long n, cudaStream_t st) {
  const long long tiles = tiles_of(n);
  seg_scan<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      x, out, tiles > 1 ? scratch : nullptr, n, kTile, kTile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  err = scan_propagate(scratch, scratch, scratch + tiles, tiles, st);
  if (err != cudaSuccess) return err;
  add_offsets<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(out, scratch,
                                                                   n);
  return cudaGetLastError();
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
  if (n < 0 || tiles_of(n) > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int prev;
  cudaError_t err = enter_device(device, &prev);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  scan_lookback<<<static_cast<unsigned>(tiles), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), n);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// Exclusive scan of x into out, GPUPrefixSum's way. scratch holds the
// totals of every level: sum of ceil(m / kTile) over m = n, ceil(n /
// kTile), ... while m > kTile. Returns a cudaError_t.
extern "C" int lsd_scan_propagate(const void* x, void* out, void* scratch,
                                  long long n, void* stream) {
  if (n < 0 || tiles_of(n) > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  return scan_propagate(static_cast<const uint32_t*>(x),
                        static_cast<uint32_t*>(out),
                        static_cast<uint32_t*>(scratch), n,
                        static_cast<cudaStream_t>(stream));
}
