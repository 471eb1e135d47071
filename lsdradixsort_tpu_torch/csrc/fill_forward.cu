// Fill-forward of the last flagged row for Hopper (sm_90a).
//
// Replaces the Pallas kernel of lsdradixsort_tpu/kernels/fill_forward.py:
// fill_forward_last (_ff_kernel). For each row i, with j the last row at
// or before i whose flag byte is not 0: okey[i] = key[j], oval[i] = val[j],
// ovalid[i] = 1; rows before the first flagged row get (0, 0, 0).
//
// The TPU kernel fills a (rows, 128) tile with log2(tile) masked roll
// steps and threads a carry (valid, key, val) through grid steps that run
// in order. CUDA blocks run in no order, and the card gathers well, so
// here the fill is an inclusive max-scan of (flag ? i : -1) and a gather
// at the result, in three launches:
//
//  * ff_tile_last: the last flagged row of each kTile-row tile, or -1.
//  * ff_carry (one block): an exclusive max-scan of those, in place: each
//    tile's carry-in, the last flagged row before it.
//  * ff_fill: each block stages its tile's flags in shared memory as
//    (flag ? i : -1), 16 consecutive rows a thread; a running max in
//    registers, a warp shuffle scan and a scan of the warp maxima give
//    every row its last flagged row, and the block then writes the three
//    outputs coalesced, gathering key and val at that row. The gathered
//    rows ascend with i, so the gathers hit the same lines as their
//    neighbours' and stay in L1/L2.
//
// What bounds it on the H100: device-memory bytes. The function needs each
// flag byte, key and val at the flagged rows only, and writes 12 bytes a
// row: n + 8 * (flagged rows) + 12 n bytes in all. This design reads the
// flags twice, and its gathers read key and val a 32-byte sector at a time
// (each sector from device memory once, as the gathered rows ascend). The
// scan is a max over 16 registers and 10 shuffles a thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // 4096 rows a block
constexpr int kWarps = kThreads / 32;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory index with one pad word after every 32, so a thread's 16
// consecutive words sit in banks no other lane of its warp uses.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, y);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
ff_tile_last(const uint8_t* __restrict__ flag, int* __restrict__ last,
             long long n) {
  __shared__ int wmax[kWarps];
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - c0));
  int m = -1;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    if (flag[c0 + i]) m = static_cast<int>(c0 + i);
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {              // m is warp 0's maximum
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max(m, wmax[w]);
    last[blockIdx.x] = m;
  }
}

// In place, last[t] becomes the max of last[0 .. t-1] (-1 for t = 0).
__global__ void __launch_bounds__(kCarryThreads)
ff_carry(int* last, int tiles) {
  __shared__ int wmax[kCarryThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int carry = -1;
  for (int c0 = 0; c0 < tiles; c0 += kCarryThreads) {
    const int i = c0 + threadIdx.x;
    const int incl = warp_inclusive_max(i < tiles ? last[i] : -1, lane);
    if (lane == 31) wmax[w] = incl;
    __syncthreads();
    if (w == 0) wmax[lane] = warp_inclusive_max(wmax[lane], lane);
    __syncthreads();
    const int excl = __shfl_up_sync(kFull, incl, 1);
    int before = max(carry, w > 0 ? wmax[w - 1] : -1);
    if (lane > 0) before = max(before, excl);
    if (i < tiles) last[i] = before;
    carry = max(carry, wmax[kCarryThreads / 32 - 1]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
ff_fill(const uint8_t* __restrict__ flag, const uint32_t* __restrict__ key,
        const uint32_t* __restrict__ val, const int* __restrict__ carry,
        uint32_t* __restrict__ okey, uint32_t* __restrict__ oval,
        uint32_t* __restrict__ ovalid, long long n) {
  __shared__ int s[kTile + kTile / 32];
  __shared__ int wmax[kWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - c0));
  for (int i = t; i < kTile; i += kThreads) {
    s[pad(i)] = i < len && flag[c0 + i] ? static_cast<int>(c0 + i) : -1;
  }
  __syncthreads();
  int v[kItems];
  int run = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = max(run, s[pad(t * kItems + k)]);
    v[k] = run;
  }
  const int incl = warp_inclusive_max(run, lane);
  if (lane == 31) wmax[w] = incl;
  __syncthreads();
  int before = carry[blockIdx.x];
  for (int i = 0; i < w; ++i) before = max(before, wmax[i]);
  const int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane > 0) before = max(before, excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) s[pad(t * kItems + k)] = max(v[k], before);
  __syncthreads();
  for (int i = t; i < len; i += kThreads) {
    const int j = s[pad(i)];
    const long long r = c0 + i;
    const bool ok = j >= 0;
    okey[r] = ok ? key[j] : 0u;
    oval[r] = ok ? val[j] : 0u;
    ovalid[r] = ok ? 1u : 0u;
  }
}

}  // namespace

// Fill-forward of n < 2^31 rows: flag bytes (0 or not), u32 key and val;
// outputs okey, oval, ovalid (u32). scratch holds scratch_len int32, at
// least one for each kTile rows: the wrapper sizes it from its own copy of
// the tile (kernels/fill_forward.py BLOCK_ROWS), and a shorter one is
// refused here. Returns a cudaError_t.
extern "C" int lsd_fill_forward(const void* flag, const void* key,
                                const void* val, void* scratch,
                                long long scratch_len, void* okey, void* oval,
                                void* ovalid, long long n, void* stream) {
  if (n < 0 || n >= (1LL << 31)) return cudaErrorInvalidValue;
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  if (scratch_len < tiles) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(flag);
  int* last = static_cast<int*>(scratch);
  ff_tile_last<<<tiles, kThreads, 0, st>>>(f, last, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff_carry<<<1, kCarryThreads, 0, st>>>(last, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff_fill<<<tiles, kThreads, 0, st>>>(
      f, static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(val),
      last, static_cast<uint32_t*>(okey), static_cast<uint32_t*>(oval),
      static_cast<uint32_t*>(ovalid), n);
  return cudaGetLastError();
}
