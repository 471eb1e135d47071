// Per-block digit histograms for Hopper (sm_90a).
//
// Replaces the Pallas kernel of lsdradixsort_tpu/kernels/histogram.py:
// block_digit_histograms (_hist_kernel, with 8- and 4-bit counters) and,
// through it, digit_histogram. out[b * 2^r + d] counts the keys of block b
// (rows [b * B, (b + 1) * B)) whose r-bit digit `group` is d.
//
// The TPU kernel packs one-hot byte or nibble counters into u32 lanes
// because the TPU has no atomics. Hopper has shared-memory atomics, so this
// is the reference's own design (BuildHistogramsKernel, LSDRadixSort.cu:
// 660-702): a CTA keeps 2^r u32 counters for each block it covers in shared
// memory and adds to them with atomicAdd. The counts come out exact, so the
// TPU's counter width never shows.
//
// What bounds it on the H100: one read of the keys (4 bytes a key) and one
// write of the counts. A key costs a shift, a mask and a shared-memory
// atomic. Skewed keys would send a warp's 32 atomics to one counter, where
// they serialise; the warp first groups its lanes by counter
// (__match_any_sync) and one lane adds the group's size, so all-equal keys
// cost one atomic a warp. A CTA covers about kCtaKeys keys: several whole
// blocks when B is small (a set of counters each), or one part of a block
// when B is large (the parts then add into the zeroed output with global
// atomics). Every block is a multiple of 128 keys, so the warps of a CTA
// are always whole, as __match_any_sync with a full mask needs.
//
// Above r = 12 a block's 2^r counters (16 KB at r = 12) no longer fit
// beside enough CTAs in shared memory, so block_histograms_global keeps
// them in the zeroed output instead and adds with global atomics, after
// the same grouping of a warp's lanes by counter. The TPU kernel has no
// limit on r; this path serves r = 13..31, where the counters (4 bytes x
// 2^r a block) and not the keys set the bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 12;              // 2^12 counters of a block: 16 KB
constexpr int kCtaKeys = 1 << 13;      // keys a CTA covers, about
constexpr int kMaxCounters = 1 << 13;  // counters a CTA keeps: 32 KB

__global__ void __launch_bounds__(kThreads)
block_histograms(const uint32_t* __restrict__ keys, uint32_t* __restrict__ out,
                 long long nblocks, int block_size, int parts, int span,
                 int bpc, int r, int shift) {
  extern __shared__ uint32_t cnt[];
  const int bins = 1 << r;
  long long blk0, lo, hi;  // first block covered; keys [lo, hi)
  int nblk;
  if (parts > 1) {
    blk0 = blockIdx.x / parts;
    const long long start = blk0 * block_size;
    lo = start + static_cast<long long>(blockIdx.x % parts) * span;
    hi = min(start + block_size, lo + span);
    nblk = 1;
  } else {
    blk0 = static_cast<long long>(blockIdx.x) * bpc;
    nblk = static_cast<int>(min(static_cast<long long>(bpc), nblocks - blk0));
    lo = blk0 * block_size;
    hi = lo + static_cast<long long>(nblk) * block_size;
  }
  for (int j = threadIdx.x; j < nblk * bins; j += kThreads) cnt[j] = 0;
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(bins - 1);
  const long long base = blk0 * block_size;
  const int lane = threadIdx.x & 31;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t d = shift < 32 ? (keys[i] >> shift) & mask : 0u;
    const uint32_t c =
        static_cast<uint32_t>(i - base) / static_cast<uint32_t>(block_size) *
            static_cast<uint32_t>(bins) + d;
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    if (lane == __ffs(peers) - 1) atomicAdd(&cnt[c], __popc(peers));
  }
  __syncthreads();
  uint32_t* o = out + blk0 * bins;
  for (int j = threadIdx.x; j < nblk * bins; j += kThreads) {
    if (parts == 1) {
      o[j] = cnt[j];
    } else if (cnt[j] != 0) {
      atomicAdd(&o[j], cnt[j]);
    }
  }
}

// r > kMaxR: the counters are the output itself, zeroed first. n is a
// multiple of 128 and the stride of kThreads, so a warp's lanes are all
// in range or all out of it.
__global__ void __launch_bounds__(kThreads)
block_histograms_global(const uint32_t* __restrict__ keys,
                        uint32_t* __restrict__ out, long long n,
                        long long block_size, int r, int shift) {
  const uint32_t mask = (1u << r) - 1u;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t d = shift < 32 ? (keys[i] >> shift) & mask : 0u;
    const unsigned long long c =
        (static_cast<unsigned long long>(i / block_size) << r) | d;
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    if (lane == __ffs(peers) - 1) atomicAdd(&out[c], __popc(peers));
  }
}

}  // namespace

// out (n / block_size, 2^r) u32 = per-block counts of digit `group` of the
// n u32 keys. block_size must be a positive multiple of 128 that divides n;
// 0 <= r <= 31. Returns a cudaError_t.
extern "C" int lsd_block_histograms(const void* keys, void* out, long long n,
                                    long long block_size, int r, int group,
                                    void* stream) {
  if (r < 0 || r > 31 || group < 0 || block_size < 128 ||
      block_size % 128 != 0 || block_size > (1LL << 30) ||
      n % block_size != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const long long s = static_cast<long long>(r) * group;
  const int shift = s >= 32 ? 32 : static_cast<int>(s);
  const long long nblocks = n / block_size;
  const auto st = static_cast<cudaStream_t>(stream);
  if (r > kMaxR) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(nblocks) * sizeof(uint32_t) << r, st);
    if (err != cudaSuccess) return err;
    const long long want = (n + kThreads - 1) / kThreads;
    const unsigned grid =
        static_cast<unsigned>(want < (1 << 16) ? want : (1 << 16));
    block_histograms_global<<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(out), n,
        block_size, r, shift);
    return cudaGetLastError();
  }
  const int bins = 1 << r;
  const int bs = static_cast<int>(block_size);
  int parts = 1, span = bs, bpc = 1;
  if (bs > kCtaKeys) {
    // parts of a whole number of CTA-wide steps, so warps stay whole
    parts = (bs + kCtaKeys - 1) / kCtaKeys;
    span = ((bs + parts - 1) / parts + kThreads - 1) / kThreads * kThreads;
    parts = (bs + span - 1) / span;
  } else {
    bpc = kCtaKeys / bs;
    if (bpc * bins > kMaxCounters) bpc = kMaxCounters / bins;
    if (bpc < 1) bpc = 1;
  }
  const long long grid =
      parts > 1 ? nblocks * parts : (nblocks + bpc - 1) / bpc;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (parts > 1) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(nblocks) * bins * sizeof(uint32_t), st);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = static_cast<size_t>(bpc) * bins * sizeof(uint32_t);
  block_histograms<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(out),
      nblocks, bs, parts, span, bpc, r, shift);
  return cudaGetLastError();
}
