// Exclusive prefix sums for Hopper (sm_90a).
//
// Replaces the Pallas kernels of lsdradixsort_tpu/kernels/scan.py:
// exclusive_scan (_scan_kernel), exclusive_scan_hierarchical
// (_block_totals_kernel, _scan_fixup_kernel) and block_prefix_sums
// (_block_scan_kernel). Every add is a u32 add mod 2^32; an i32 input is
// the same bits.
//
// The TPU sweeps its grid in order and threads one carry through it. CUDA
// CTAs run in no fixed order, so the scans are built from three kernels:
//
//  * seg_scan: a CTA scans kTile = 4096 words at a time in shared memory
//    (16 a thread, warp shuffles across a warp, one warp across the
//    warps), exclusive within segments of `seg` words: several whole
//    segments in one tile when seg < kTile, or one segment a CTA, looping
//    over its tiles with a running carry, when seg >= kTile. It can add an
//    offset to each segment and write each segment's total. Alone it is
//    block_prefix_sums (the reference's BlockPrefixSumKernel with its
//    carry-out of block totals, LSDRadixSort.cu:180-207).
//  * tile_totals: the sum of each tile (a pass that only reads).
//  * add_offsets: out[p] += offsets[p / kTile] (AddBlockSumsKernel, cu:278).
//
// lsd_scan_propagate is the reference's GPUPrefixSum (cu:286-302) and the
// port of exclusive_scan_hierarchical: seg_scan with tile totals out, the
// same scan of the totals (recursively, in place, in scratch the caller
// gives), then add_offsets; it reads and writes the data twice. The
// port's exclusive_scan is reduce-then-scan: tile_totals, a scan of the
// totals, then seg_scan with the scanned totals as offsets; two reads and
// one write.
//
// What bounds them on the H100: device-memory bytes (4 bytes a word each
// time it is read or written); a word costs two adds. A single pass with
// decoupled look-back (one read, one write) is the next step.
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
// short), plus offsets[k] for segment k when offsets is given; totals[k]
// gets segment k's sum when totals is given. A CTA covers `span` words:
// span == seg when seg >= kTile, else a whole number of segments <= kTile.
// x may be out (each CTA reads a tile before it writes it).
__global__ void __launch_bounds__(kThreads)
seg_scan(const uint32_t* x, uint32_t* out, uint32_t* totals,
         const uint32_t* offsets, long long n, long long seg,
         long long span) {
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
      const uint32_t add = carry + (offsets ? offsets[blockIdx.x] : 0u);
      for (int i = threadIdx.x; i < len; i += kThreads) {
        out[c0 + i] = s[pad(i)] + add;
      }
      carry += total;
    } else {
      // c0 == base: the CTA's segments all lie in this one tile
      const int sg = static_cast<int>(seg);
      const long long k0 = c0 / sg;
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const int st = i - i % sg;
        out[c0 + i] = s[pad(i)] - s[pad(st)] +
                      (offsets ? offsets[k0 + i / sg] : 0u);
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

__global__ void __launch_bounds__(kThreads)
tile_totals(const uint32_t* __restrict__ x, uint32_t* __restrict__ totals,
            long long n) {
  __shared__ uint32_t wsum[kWarps];
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - c0));
  uint32_t sum = 0;
  for (int i = threadIdx.x; i < len; i += kThreads) sum += x[c0 + i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < kWarps; ++w) t += wsum[w];
    totals[blockIdx.x] = t;
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
      x, out, tiles > 1 ? scratch : nullptr, nullptr, n, kTile, kTile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  err = scan_propagate(scratch, scratch, scratch + tiles, tiles, st);
  if (err != cudaSuccess) return err;
  add_offsets<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(out, scratch,
                                                                   n);
  return cudaGetLastError();
}

}  // namespace

// Words a scan tile holds: tile_totals writes one total per tile.
extern "C" int lsd_scan_tile() { return kTile; }

// Exclusive scans of the segments of `seg` words of x into out; offsets
// (one per segment) are added when not null, and totals (one per segment)
// written when not null. seg >= 1; x may equal out. Returns a cudaError_t.
extern "C" int lsd_seg_scan(const void* x, void* out, void* totals,
                            const void* offsets, long long n, long long seg,
                            void* stream) {
  if (seg < 1 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long span = seg >= kTile ? seg : kTile / seg * seg;
  const long long grid = (n + span - 1) / span;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  seg_scan<<<static_cast<unsigned>(grid), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(totals), static_cast<const uint32_t*>(offsets),
      n, seg, span);
  return cudaGetLastError();
}

// totals[t] = the sum of tile t (kTile words) of x; the last may be short.
extern "C" int lsd_tile_totals(const void* x, void* totals, long long n,
                               void* stream) {
  if (n < 0 || tiles_of(n) > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  tile_totals<<<static_cast<unsigned>(tiles_of(n)), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(totals), n);
  return cudaGetLastError();
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
