// The pieces that the single-pass kernels share: scan.cu's scan_lookback
// and scan_rounds, compaction.cu's compact_tiles, and aggregate.cu's
// filtered_runs (the ticket and status words, with a walk of its own over
// a pair of values a word). Each .cu is built by
// an nvcc call of its own and includes this header, so everything here is
// local to the source that includes it (an anonymous namespace).
//
//  * Copies from device memory into shared memory with cp.async: they need
//    no registers and run on while the thread goes on; a thread waits for
//    its own with cp_async_wait_all (a barrier after it for other
//    threads' copies).
//  * Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
//    Scan with Decoupled Look-back", NVIDIA, 2016) over a 64-bit scratch
//    `status` that the caller keeps per stream: status[0] the ticket,
//    status[1] the count of CTAs done (each a u32 in its 64-bit word),
//    status[2 + t] the status word of tile t, a 2-bit flag (0 not ready,
//    1 aggregate, 2 inclusive prefix) above the 32-bit value. Flag and
//    value travel in one aligned 64-bit word, which a strong access moves
//    whole, and a reader needs nothing that the writer wrote before it;
//    so the words are written and read relaxed, at gpu scope: a release
//    store or an acquire load would add a fence to every step of the
//    walk. A CTA takes its
//    tile from the ticket, not from blockIdx, so every tile before it
//    belongs to a CTA that has started, and a look-back never waits on
//    one that cannot run. The last CTA to finish clears the scratch, so
//    it is all zero again for the next launch on the stream.
//
// Each piece with inline PTX has a plain C++ twin for the host pass, so
// the sources also build with a host compiler against stub CUDA headers.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

// --- copies into shared memory --------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 4);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;" ::: "memory");
#endif
}

// --- decoupled look-back --------------------------------------------------

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
#endif
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
#ifdef __CUDA_ARCH__
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

// One thread: this CTA's tile, from the ticket.
__device__ __forceinline__ long long take_ticket(unsigned long long* status) {
  return atomicAdd(reinterpret_cast<unsigned int*>(status), 1u);
}

// One thread: publish the tile's aggregate `total` (tile 0: its inclusive
// prefix), so that the CTAs after it can walk past it.
__device__ __forceinline__ void publish_aggregate(unsigned long long* status,
                                                  long long tile,
                                                  uint32_t total) {
  store_status(status + 2 + tile, (tile == 0 ? kPrefix : kAggregate) | total);
}

// One whole warp, after publish_aggregate: the tile's exclusive prefix,
// to every lane. It reads the status words of the 32 tiles before it at a
// time (lane l reads tile j - l), backing off while one is not ready, and
// sums aggregates back to the nearest tile that has published its
// inclusive prefix; then it publishes its own (excl + total).
__device__ uint32_t walk_back(unsigned long long* status, long long tile,
                              uint32_t total) {
  if (tile == 0) return 0;
  const int lane = threadIdx.x & 31;
  unsigned long long* word = status + 2;
  uint32_t excl = 0;
  for (long long j = tile - 1;; j -= 32) {
    const long long t = j - lane;
    unsigned long long w = t >= 0 ? load_status(word + t) : kPrefix;
    unsigned backoff = 32;
    while (__any_sync(0xffffffffu, (w >> 32) == 0)) {
      __nanosleep(backoff);  // spare the status lines while they wait
      if (backoff < 1024) backoff <<= 1;
      if ((w >> 32) == 0) w = load_status(word + t);
    }
    const unsigned pmask = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int first = pmask ? __ffs(pmask) - 1 : 32;
    uint32_t v = lane <= first ? static_cast<uint32_t>(w) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (pmask) break;
  }
  if (lane == 0) store_status(word + tile, kPrefix | (excl + total));
  return excl;
}

// The thread that wrote the CTA's status words, once its CTA reads none
// any more: count the CTA done; true for the last of `tiles`, which must
// then clear_status. The fences order every CTA's status writes before
// its count, and the last CTA's clearing after them all.
__device__ __forceinline__ bool finish_tile(unsigned long long* status,
                                            long long tiles) {
  __threadfence();
  const bool last =
      atomicAdd(reinterpret_cast<unsigned int*>(status + 1), 1u) == tiles - 1;
  if (last) __threadfence();
  return last;
}

// Every thread of the last CTA: zero the ticket, the count and the status
// words, for the next launch.
__device__ __forceinline__ void clear_status(unsigned long long* status,
                                             long long tiles) {
  for (long long t = threadIdx.x; t < tiles + 2; t += blockDim.x) {
    status[t] = 0;
  }
}

// --- launches --------------------------------------------------------------

// Makes `device` current; returns the device that was (to restore).
inline cudaError_t enter_device(int device, int* prev) {
  *prev = device;
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace
