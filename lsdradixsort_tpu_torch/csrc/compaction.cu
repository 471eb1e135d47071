// Order-preserving stream compaction for Hopper (sm_90a).
//
// Replaces the Pallas kernel of lsdradixsort_tpu/kernels/compaction.py:
// compact_stream_multi (_compact_kernel) and, through it, compact_stream.
// Given one byte mask (0 or 1 a row) and k u32 streams of n rows, the first
// count rows of each output are that stream's selected rows in input order;
// the rest of the output is left as it was.
//
// The TPU kernel walks its 32K tiles in order: a bitonic partition of the
// composite (!pred, position) key inside each tile, a carry of fewer than
// 128 rows rolled into the next tile, and DMAs at a running output cursor
// kept in SMEM. All three exist because TPU grid steps run in order and the
// TPU has no scatter. Here one launch, compact_tiles, moves up to 8 streams
// in one pass, a CTA a tile of T = kThreads * R rows (R = 32 for one or
// two streams, 16 for more; the wrapper picks, kernels/compaction.py
// tile_rows):
//
//  * The CTA takes its tile from the look-back ticket (single_pass.cuh).
//    Each thread reads the mask bytes of R consecutive rows (16-byte loads
//    where aligned and whole, else byte by byte) into shared memory and
//    counts them; a warp scan and the warp totals give the tile's count,
//    which the CTA publishes as its aggregate at once.
//  * Then every thread starts the copies of its share of each stream into
//    shared memory (cp.async, no registers): 4-row chunks in the order of
//    the threads, so a warp's copies are 512 contiguous bytes; a chunk only
//    where one of its 4 mask bytes is set, 16 bytes where the stream is
//    aligned and the chunk whole, else the selected rows one by one. A
//    sparse mask reads almost none of the streams.
//  * While the copies fly, each thread writes the tile row of each of its
//    selected rows at its rank in the tile (the warp scan plus the warps
//    before it) into a shared index, and one warp walks back over the
//    status words for the tile's offset in the output.
//  * After one barrier the CTA writes, stream by stream, out[offset + j] =
//    staged[index[j]] for j below the tile's count: coalesced 4-byte stores
//    from any offset, so the ragged head and tail of each tile's run need
//    no care.
//
// More than 8 streams take one launch a group of 8: the first writes each
// tile's offset, and the later ones read it and skip the look-back. The
// tile whose rows end the data writes the total count.
//
// What bounds it on the H100: device-memory bytes. The mask is read once
// (1 byte a row); each stream's selected rows are written once (4 bytes
// each) and read a 32-byte sector at a time, so a random 25 % mask reads
// about 90 % of every stream (1 - 0.75^8 of its sectors). What keeps it
// from that bound is the look-back: a CTA holds its shared memory (T *
// (4K + 3) bytes, so 1 to 4 CTAs an SM) until its offset is known, and the
// walk adds device-memory round trips to every tile. Hence the large
// tiles, a look-back a tile of up to 8192 rows, and status words read and
// written without fences (single_pass.cuh).
#include <cstdint>
#include <cuda_runtime.h>

#include "single_pass.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStreams = 8;
constexpr size_t kMaxSmem = 232448;  // shared memory a CTA can opt into

struct Streams {
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
};

// Shared memory of a CTA of R rows a thread moving k streams: the staged
// streams (k * kTile words), the tile's mask (kTile bytes) and its index
// (kTile u16).
constexpr size_t smem_bytes(int rows, int k) {
  return static_cast<size_t>(kThreads) * rows * (4 * k + 3);
}

// The R mask bytes of this thread's rows [t * R, t * R + R) of a tile of
// len rows starting at m, each as 0 or 1, 4 to a word.
template <int R>
__device__ __forceinline__ void load_mask(const uint8_t* m, int len,
                                          uint32_t (&mw)[R / 4]) {
  const int row0 = threadIdx.x * R;
  if (len == kThreads * R && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < R / 16; ++j) {
      const uint4 v =
          reinterpret_cast<const uint4*>(m)[threadIdx.x * (R / 16) + j];
      mw[4 * j] = v.x, mw[4 * j + 1] = v.y, mw[4 * j + 2] = v.z;
      mw[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < R / 4; ++i) mw[i] = __vcmpne4(mw[i], 0u) & 0x01010101u;
  } else {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      mw[i] = 0;
      for (int b = 0; b < 4; ++b) {
        const int row = row0 + 4 * i + b;
        if (row < len && m[row] != 0) mw[i] |= 1u << (8 * b);
      }
    }
  }
}

// One CTA: the tile of rows [tile * T, tile * T + T) (T = kThreads * R),
// cut at n, of K streams. K is a template parameter so that each stream's
// pointer is read from the launch's parameters: a loop over a run-time k
// indexes s.in and s.out, which copies them to local memory in every
// thread (32 KB a CTA, as much device-memory traffic as the streams of a
// sparse mask). offsets_in null: the tile comes from the look-back ticket
// and its offset from the look-back over `status`; offsets_out, where not
// null, keeps each tile's offset. offsets_in set: tile blockIdx.x, its
// offset read from there, no look-back. count, where not null, gets the
// number of selected rows.
template <int R, int K>
__global__ void __launch_bounds__(kThreads)
compact_tiles(const uint8_t* __restrict__ mask, Streams s, long long n,
              unsigned long long* status, const uint32_t* offsets_in,
              uint32_t* offsets_out, uint32_t* count) {
  constexpr int T = kThreads * R;
  constexpr int kChunks = R / 4;  // 4-row chunks a thread, per stream
  extern __shared__ uint4 smem[];
  uint32_t* staged = reinterpret_cast<uint32_t*>(smem);   // K * T words
  uint32_t* smask = staged + K * T;                        // T bytes
  uint16_t* index = reinterpret_cast<uint16_t*>(smask + T / 4);  // T rows
  __shared__ uint32_t wsum[kWarps];
  __shared__ long long s_tile;
  __shared__ uint32_t s_excl;
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long tiles = (n + T - 1) / T;
  if (t == 0) s_tile = offsets_in ? blockIdx.x : take_ticket(status);
  __syncthreads();
  const long long tile = s_tile;
  const long long r0 = tile * T;
  const int len = static_cast<int>(n - r0 < T ? n - r0 : T);

  // the mask: this thread's rows into shared memory, counted and ranked
  uint32_t mw[kChunks];
  load_mask<R>(mask + r0, len, mw);
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    smask[t * kChunks + i] = mw[i];
    c += __popc(mw[i]);
  }
  uint32_t incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  uint32_t rank = incl - c, total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i < w) rank += wsum[i];
    total += wsum[i];
  }
  if (!offsets_in && t == 0) publish_aggregate(status, tile, total);

  // the streams: every copy started before anything waits
  uint32_t cm[kChunks];  // the mask of chunk i * kThreads + t
#pragma unroll
  for (int i = 0; i < kChunks; ++i) cm[i] = smask[i * kThreads + t];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const uint32_t* x = s.in[q] + r0;
    uint32_t* dst = staged + q * T;
    const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int row = 4 * (i * kThreads + t);
      if (cm[i] == 0) continue;
      if (vec && row + 4 <= len) {
        cp_async16(dst + row, x + row);
      } else {
        for (int b = 0; b < 4; ++b) {
          if ((cm[i] >> (8 * b)) & 1u) cp_async4(dst + row + b, x + row + b);
        }
      }
    }
  }
  cp_async_commit();

  // while they fly: the index of the selected rows, and the tile's offset
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    for (int b = 0; b < 4; ++b) {
      if ((mw[i] >> (8 * b)) & 1u) index[rank++] = t * R + 4 * i + b;
    }
  }
  if (w == 0) {
    const uint32_t excl =
        offsets_in ? offsets_in[tile] : walk_back(status, tile, total);
    if (lane == 0) {
      s_excl = excl;
      if (offsets_out) offsets_out[tile] = excl;
      if (count && tile == tiles - 1) *count = excl + total;
      s_last = !offsets_in && finish_tile(status, tiles);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const long long at = s_excl;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    uint32_t* out = s.out[q] + at;
    const uint32_t* src = staged + q * T;
    for (uint32_t j = t; j < total; j += kThreads) out[j] = src[index[j]];
  }
  if (s_last) clear_status(status, tiles);
}

struct Launch {
  const uint8_t* mask;
  Streams s;
  long long n;
  unsigned long long* status;
  const uint32_t* offsets_in;
  uint32_t* offsets_out;
  uint32_t* count;
  int device;
  cudaStream_t stream;
};

// One launch of compact_tiles<R, K>; the first on a device lets it take
// its shared memory.
template <int R, int K>
cudaError_t launch(const Launch& a) {
  static bool ready[64] = {};
  if (a.device < 0 || a.device >= 64) return cudaErrorInvalidDevice;
  if (!ready[a.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        compact_tiles<R, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(R, K)));
    if (err != cudaSuccess) return err;
    ready[a.device] = true;
  }
  const long long tiles = (a.n + kThreads * R - 1) / (kThreads * R);
  compact_tiles<R, K><<<static_cast<unsigned>(tiles), kThreads,
                        smem_bytes(R, K), a.stream>>>(
      a.mask, a.s, a.n, a.status, a.offsets_in, a.offsets_out, a.count);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_streams(const Launch& a, int k) {
  switch (k) {
    case 1: return launch<R, 1>(a);
    case 2: return launch<R, 2>(a);
    case 3: return launch<R, 3>(a);
    case 4: return launch<R, 4>(a);
    case 5: return launch<R, 5>(a);
    case 6: return launch<R, 6>(a);
    case 7: return launch<R, 7>(a);
    default: return launch<R, 8>(a);
  }
}

}  // namespace

// Threads of a CTA, and the most streams one launch moves.
extern "C" int lsd_compact_threads() { return kThreads; }
extern "C" int lsd_compact_max_streams() { return kMaxStreams; }

// Compact the k streams in[] by the n mask bytes (each 0 or 1) into out[]:
// the selected rows of each, in order, to its first rows. 1 <= k <= 8,
// 0 < n < 2^32, any alignment; out must not overlap in. Rows a tile:
// tile_rows, 4096 or 8192 (8192 takes k <= 6, whose staged rows fit in
// shared memory). status: the look-back scratch
// (single_pass.cuh) of at least n / tile_rows + 3 words, all zero, which
// the launch leaves all zero; launches that share it must be ordered (one
// stream). offsets: null, or one u32 a tile, written when `reuse` is 0
// and read (no look-back, status unused) when it is 1. count: null, or
// one u32 for the number of selected rows (written when reuse is 0). On
// `device` (made current for the launch) and `stream`. Returns a
// cudaError_t.
extern "C" int lsd_compact(const void* mask, const void* const* in,
                           void* const* out, int k, long long n,
                           int tile_rows, void* status, void* offsets,
                           int reuse, void* count, int device, void* stream) {
  if (k < 1 || k > kMaxStreams || n <= 0 || n > 0xffffffffLL ||
      (tile_rows != 16 * kThreads && tile_rows != 32 * kThreads) ||
      smem_bytes(tile_rows / kThreads, k) > kMaxSmem ||
      (reuse && offsets == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Launch a{};
  for (int q = 0; q < k; ++q) {
    a.s.in[q] = static_cast<const uint32_t*>(in[q]);
    a.s.out[q] = static_cast<uint32_t*>(out[q]);
  }
  auto* off = static_cast<uint32_t*>(offsets);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n = n;
  a.status = static_cast<unsigned long long*>(status);
  a.offsets_in = reuse ? off : nullptr;
  a.offsets_out = reuse ? nullptr : off;
  a.count = reuse ? nullptr : static_cast<uint32_t*>(count);
  a.device = device;
  a.stream = static_cast<cudaStream_t>(stream);
  int prev;
  cudaError_t err = enter_device(device, &prev);
  if (err != cudaSuccess) return err;
  err = tile_rows == 32 * kThreads ? launch_streams<32>(a, k)
                                   : launch_streams<16>(a, k);
  if (prev != device) cudaSetDevice(prev);
  return err;
}
