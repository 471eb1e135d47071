// Order-preserving stream compaction for Hopper (sm_90a).
//
// Replaces the Pallas kernel of lsdradixsort_tpu/kernels/compaction.py:
// compact_stream_multi (_compact_kernel) and, through it, compact_stream.
// Given one byte mask (0 or 1 per row) and k u32 streams of n rows, the
// first count rows of each output are that stream's selected rows in input
// order; the rest of the output is left as it was.
//
// The TPU kernel walks its 32K tiles in order: a bitonic partition of the
// composite (!pred, position) key inside each tile, a carry of fewer than
// 128 rows rolled into the next tile, and DMAs at a running output cursor
// kept in SMEM. All three exist because TPU grid steps run in order and the
// TPU has no scatter. CUDA blocks run in no order but can scatter, so here
// compaction is count, scan, scatter:
//
//  * compact_counts: the selected rows of each kTile-row tile (16 mask
//    bytes a thread, read as one 16-byte load, a byte compare and popc).
//  * the exclusive scan of the tile counts, the port's exclusive_scan
//    (csrc/scan.cu), launched by the wrapper: each tile's output offset.
//  * compact_scatter: each warp owns 512 consecutive rows of a tile. It
//    reads their mask bytes 32 at a time and keeps the 16 ballots in
//    registers; a block scan of the 8 warp totals gives the warp's offset
//    in the tile, and each selected row goes to tile offset + warp offset +
//    the popc of the ballot bits below its lane. Order is preserved by
//    construction, with no carry between blocks.
//
// What bounds it on the H100: device-memory bytes. The mask is read twice
// (1 byte a row each time), each stream's selected rows are read once and
// written once (4 bytes each); unselected rows of a stream are never read.
// The scatter's writes are contiguous runs within a warp. A single pass
// with decoupled look-back would save the second read of the mask.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                      // 32-row rounds a warp owns
constexpr int kTile = kThreads * kRounds;        // 4096 rows a block
constexpr int kMaxStreams = 8;

struct Streams {
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
};

__global__ void __launch_bounds__(kThreads)
compact_counts(const uint8_t* __restrict__ mask, uint32_t* __restrict__ counts) {
  __shared__ uint32_t wsum[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const uint4 w = reinterpret_cast<const uint4*>(mask + base)[threadIdx.x];
  uint32_t c = (__popc(__vcmpne4(w.x, 0u)) + __popc(__vcmpne4(w.y, 0u)) +
                __popc(__vcmpne4(w.z, 0u)) + __popc(__vcmpne4(w.w, 0u))) >> 3;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += wsum[i];
    counts[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_scatter(const uint8_t* __restrict__ mask,
                const uint32_t* __restrict__ offsets, Streams s, int k) {
  __shared__ uint32_t wsum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile +
                         static_cast<long long>(warp) * (32 * kRounds);
  unsigned ballot[kRounds];
  uint32_t total = 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, mask[row0 + j * 32 + lane] != 0);
    total += __popc(ballot[j]);
  }
  if (lane == 0) wsum[warp] = total;
  __syncthreads();
  uint32_t dst = offsets[blockIdx.x];
  for (int i = 0; i < warp; ++i) dst += wsum[i];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    if ((ballot[j] >> lane) & 1u) {
      const long long src = row0 + j * 32 + lane;
      const long long at = dst + __popc(ballot[j] & below);
      for (int t = 0; t < k; ++t) s.out[t][at] = s.in[t][src];
    }
    dst += __popc(ballot[j]);
  }
}

}  // namespace

// counts[t] = the selected rows of tile t (kTile mask bytes, each 0 or 1).
// counts holds `tiles` words, which must be n / kTile: the wrapper sizes it
// from its own copy of the tile (kernels/compaction.py BLOCK_ROWS), and a
// mismatch is refused here. mask must be 16-byte aligned. Returns a
// cudaError_t.
extern "C" int lsd_compact_counts(const void* mask, void* counts,
                                  long long tiles, long long n, void* stream) {
  if (n < 0 || n % kTile != 0 || tiles != n / kTile || tiles > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  compact_counts<<<static_cast<unsigned>(tiles), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint32_t*>(counts));
  return cudaGetLastError();
}

// Scatter the selected rows of the k streams in[] to out[]: the rows of
// tile t go to offsets[t] onward, in input order (offsets: the exclusive
// scan of lsd_compact_counts). 1 <= k <= 8, n a multiple of kTile. Returns
// a cudaError_t.
extern "C" int lsd_compact_scatter(const void* mask, const void* offsets,
                                   const void* const* in, void* const* out,
                                   int k, long long n, void* stream) {
  if (k < 1 || k > kMaxStreams || n < 0 || n % kTile != 0 ||
      n / kTile > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  Streams s{};
  for (int t = 0; t < k; ++t) {
    s.in[t] = static_cast<const uint32_t*>(in[t]);
    s.out[t] = static_cast<uint32_t*>(out[t]);
  }
  compact_scatter<<<static_cast<unsigned>(n / kTile), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const uint32_t*>(offsets),
      s, k);
  return cudaGetLastError();
}
