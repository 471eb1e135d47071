// Per-tile bitonic sort for Hopper (sm_90a).
//
// Replaces the Pallas kernels of lsdradixsort_tpu/kernels/tile_sort.py:
// sort_tiles (_bitonic_keys_kernel), sort_tiles_kv (_bitonic_kernel) and
// sort_tiles_multi (_bitonic_multi_kernel). Every tile of T = 2^tile_log2
// rows is sorted ascending by its "words": the key, then up to three more
// u32 words compared lexicographically (the compared payloads, one or two,
// then the row's index inside its tile when payloads ride). Word 1 is
// compared after XOR with `flip1` (0x80000000 compares it as a signed
// int32, the sort_tiles_kv rule). A pair whose words tie never swaps.
//
// What bounds it on the H100: a 2^15-row tile of one word is 128 KB and
// fits one block's shared memory (227 KB), but 2, 3 or 4 words (256,
// 384 or 512 KB) do not. Design: a shared-memory kernel sorts sub-tiles of
// S = 2^sub_log2 rows (128 KB of words at most) and finishes the low
// stages (distance < S) of every later bitonic phase; the few stages with
// distance >= S run as one compare-exchange pass over device memory each,
// one thread per pair, reading and writing whole rows. For T = 2^15 that
// is 0, 1 or 3 device-memory stages for 1, 2 or 3-4 words. Each stage
// moves every word twice through device memory (3.35 TB/s), so the sort is
// bandwidth bound; making the sub-tile larger (clusters sharing shared
// memory) is the next step.
//
// Riding payloads are not moved by the network: the host adds the row's
// index in its tile as the last compared word (unique, so the sort is
// stable) and lsd_gather_tiles moves each rider by that index afterwards.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 4;
constexpr int kBlockThreads = 1024;
constexpr int kStageThreads = 256;

struct Words {
  const uint32_t* src[kMaxWords];  // nullptr: the row's index in its tile
  uint32_t* dst[kMaxWords];
};

template <int W>
__device__ __forceinline__ bool greater(const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        uint32_t flip1) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t f = w == 1 ? flip1 : 0u;
    const uint32_t x = a[w] ^ f, y = b[w] ^ f;
    if (x != y) return x > y;
  }
  return false;
}

// Ascending unless bit kl of the row's index in its tile is set; the last
// phase (kl == tile_log2) is ascending everywhere.
__device__ __forceinline__ bool ascending(long long row, int kl,
                                          int tile_log2) {
  return kl >= tile_log2 || ((row >> kl) & 1) == 0;
}

// One block per sub-tile of S = 2^sub_log2 rows: load the words into
// shared memory, run phases kl = k_begin..k_end (only their stages with
// distance < S), store. k_begin = 1, k_end = sub_log2 sorts the sub-tile;
// k_begin = k_end = kl > sub_log2 finishes the low stages of phase kl.
template <int W>
__global__ void __launch_bounds__(kBlockThreads)
bitonic_local(Words io, int tile_log2, int sub_log2, int k_begin, int k_end,
              uint32_t flip1) {
  extern __shared__ uint32_t sm[];
  const int S = 1 << sub_log2;
  const long long base = static_cast<long long>(blockIdx.x) << sub_log2;
  const long long tile_mask = (1LL << tile_log2) - 1;
  for (int l = threadIdx.x; l < S; l += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t* s = io.src[w];
      sm[w * S + l] = s ? s[base + l]
                        : static_cast<uint32_t>((base + l) & tile_mask);
    }
  }
  __syncthreads();
  for (int kl = k_begin; kl <= k_end; ++kl) {
    for (int jl = min(kl, sub_log2) - 1; jl >= 0; --jl) {
      for (int p = threadIdx.x; p < S / 2; p += blockDim.x) {
        const int lo = ((p >> jl) << (jl + 1)) | (p & ((1 << jl) - 1));
        const int hi = lo | (1 << jl);
        uint32_t a[W], b[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          a[w] = sm[w * S + lo];
          b[w] = sm[w * S + hi];
        }
        const bool up = ascending(base + lo, kl, tile_log2);
        if (up ? greater<W>(a, b, flip1) : greater<W>(b, a, flip1)) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            sm[w * S + lo] = b[w];
            sm[w * S + hi] = a[w];
          }
        }
      }
      __syncthreads();
    }
  }
  for (int l = threadIdx.x; l < S; l += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) io.dst[w][base + l] = sm[w * S + l];
  }
}

// One compare-exchange stage at distance 2^jl >= S over device memory, in
// place on io.dst: one thread per pair.
template <int W>
__global__ void __launch_bounds__(kStageThreads)
bitonic_stage(Words io, long long npairs, int tile_log2, int kl, int jl,
              uint32_t flip1) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npairs) return;
  const long long lo = ((p >> jl) << (jl + 1)) | (p & ((1LL << jl) - 1));
  const long long hi = lo + (1LL << jl);
  uint32_t a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a[w] = io.dst[w][lo];
    b[w] = io.dst[w][hi];
  }
  const bool up = ascending(lo, kl, tile_log2);
  if (up ? greater<W>(a, b, flip1) : greater<W>(b, a, flip1)) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      io.dst[w][lo] = b[w];
      io.dst[w][hi] = a[w];
    }
  }
}

__global__ void __launch_bounds__(kStageThreads)
gather_tiles(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
             const uint32_t* __restrict__ idx, long long n, int tile_log2) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const long long tile_base = (g >> tile_log2) << tile_log2;
  dst[g] = src[tile_base + idx[g]];
}

// Largest sub-tile whose W words fit 128 KB of shared memory.
constexpr int sub_log2_max(int W) { return W == 1 ? 15 : (W == 2 ? 14 : 13); }
static_assert(4 * (1 << sub_log2_max(kMaxWords)) * kMaxWords <= 128 * 1024,
              "a sub-tile of kMaxWords words must fit 128 KB");

constexpr int imin(int a, int b) { return a < b ? a : b; }

template <int W>
cudaError_t sort_tiles(Words io, long long n, int tile_log2, uint32_t flip1,
                       cudaStream_t stream) {
  const int sub_log2 = imin(tile_log2, sub_log2_max(W));
  const int S = 1 << sub_log2;
  const int smem = W * S * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_local<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = imin(S / 2, kBlockThreads);
  const unsigned blocks = static_cast<unsigned>(n >> sub_log2);
  bitonic_local<W><<<blocks, threads, smem, stream>>>(
      io, tile_log2, sub_log2, 1, sub_log2, flip1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  Words inplace = io;
  for (int w = 0; w < W; ++w) inplace.src[w] = io.dst[w];
  const long long npairs = n / 2;
  const unsigned stage_blocks =
      static_cast<unsigned>((npairs + kStageThreads - 1) / kStageThreads);
  for (int kl = sub_log2 + 1; kl <= tile_log2; ++kl) {
    for (int jl = kl - 1; jl >= sub_log2; --jl) {
      bitonic_stage<W><<<stage_blocks, kStageThreads, 0, stream>>>(
          inplace, npairs, tile_log2, kl, jl, flip1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bitonic_local<W><<<blocks, threads, smem, stream>>>(
        inplace, tile_log2, sub_log2, kl, kl, flip1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Sort every tile of 2^tile_log2 rows of `nwords` (1..4) u32 words.
// src[w] == nullptr makes word w the row's index in its tile. n must be a
// multiple of the tile; 1 <= tile_log2 <= 30. Returns a cudaError_t.
extern "C" int lsd_sort_tiles(const void* const* src, void* const* dst,
                              int nwords, long long n, int tile_log2,
                              unsigned int flip1, void* stream) {
  if (nwords < 1 || nwords > kMaxWords || tile_log2 < 1 || tile_log2 > 30 ||
      n % (1LL << tile_log2) != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  Words io{};
  for (int w = 0; w < nwords; ++w) {
    io.src[w] = static_cast<const uint32_t*>(src[w]);
    io.dst[w] = static_cast<uint32_t*>(dst[w]);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (nwords) {
    case 1: return sort_tiles<1>(io, n, tile_log2, flip1, st);
    case 2: return sort_tiles<2>(io, n, tile_log2, flip1, st);
    case 3: return sort_tiles<3>(io, n, tile_log2, flip1, st);
    case 4: return sort_tiles<4>(io, n, tile_log2, flip1, st);
    default: return cudaErrorInvalidValue;
  }
}

// dst[g] = src[tile_base(g) + idx[g]]: move a riding stream by the tile
// permutation that lsd_sort_tiles left in its index word.
extern "C" int lsd_gather_tiles(const void* src, void* dst, const void* idx,
                                long long n, int tile_log2, void* stream) {
  if (n == 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((n + kStageThreads - 1) / kStageThreads);
  gather_tiles<<<blocks, kStageThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const uint32_t*>(idx), n, tile_log2);
  return cudaGetLastError();
}

extern "C" const char* lsd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
