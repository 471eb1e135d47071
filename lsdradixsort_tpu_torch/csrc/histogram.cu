// Per-block digit histograms for Hopper (sm_90a).
//
// Replaces the Pallas kernel of lsdradixsort_tpu/kernels/histogram.py:
// block_digit_histograms (_hist_kernel, with 8- and 4-bit counters) and,
// through it, digit_histogram. out[b * 2^r + d] counts the keys of block b
// (rows [b * B, (b + 1) * B)) whose r-bit digit `group` is d.
//
// The TPU kernel packs one-hot byte or nibble counters into u32 lanes
// because the TPU has no atomics. Here a counting group (a warp, or at
// r > 8 the whole CTA) keeps u32 counters in shared memory and adds to
// them, as the reference's BuildHistogramsKernel (LSDRadixSort.cu:660-702)
// does; the counts are exact, so the TPU's counter width never shows.
//
// What bounds it on the H100: one read of the keys (4 bytes a key) at the
// card's read rate, and one write of the counts (chip_smoke.py measures
// both rates and prints each call's bound). On an H100 SXM (700 W) this
// design takes 0.188 / 0.180 / 0.177 / 0.177 ms for 2^27 keys at r = 8 /
// 4 / 2 / 1, block 2^13, uniform, all-equal or presorted keys alike (the
// matching design of before: 1.062 / 0.510 / 0.274 / 0.272 on uniform
// keys).
// The keys arrive as 16-byte vectors, four in flight a thread before it
// counts, so few warps keep enough bytes in flight. Counting must then
// stay under the read at every skew, without grouping a warp's lanes by
// counter (__match_any_sync, whose cost grows with the distinct counters
// in the warp and made uniform keys the slow case):
//   - a thread merges equal digits that follow each other among its keys
//     and adds each run once, so all-equal and presorted keys cost one add
//     a run, not a key;
//   - r <= 4 (kLane): each lane owns a column of its warp's counters,
//     counter d of lane l at d * 32 + l, so a lane's add is a plain
//     read-modify-write in its own bank, with no atomic and no conflict;
//     a unit's 32 columns are summed with __reduce_add_sync;
//   - r = 5..8 (kWarp): one copy of the 2^r counters a warp (8 KB a CTA at
//     r = 8), added to with shared atomics; lanes of a warp meet only on
//     their own warp's copy, and skew meets the run merging first;
//   - r = 9..12 (kCta): one copy a CTA (16 KB at r = 12).
// A counting group takes units of at most kernels/histogram.py
// UNIT_KEYS keys one after another (a persistent grid, one wave of CTAs):
// a whole block, or a part of a larger block, whose counts then add into
// the zeroed output with global atomics. After each unit the group writes
// its counts and zeroes its counters in the same pass.
//
// Above r = 12 a block's 2^r counters no longer fit beside enough CTAs in
// shared memory, so block_histograms_global keeps them in the zeroed
// output instead and adds with global atomics, after grouping a warp's
// lanes by counter. The TPU kernel has no limit on r; this path serves
// r = 13..31, where the counters (4 bytes x 2^r a block) and not the keys
// set the bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 12;           // 2^12 counters of a CTA: 16 KB
// the counters' keeping by r, as kernels/histogram.py `hist_plan` picks it
// (LANE_MAX_R, WARP_MAX_R, SHARED_MAX_R = kMaxR)
constexpr int kLaneMaxR = 4;
constexpr int kWarpMaxR = 8;
constexpr int kMinCtas = 4;         // CTAs an SM holds: up to 64 registers

enum : int { kLane = 0, kWarp = 1, kCta = 2 };

// Counters of a thread's counting group: bin d of this thread at c[d * S].
template <int MODE>
struct Counters {
  static constexpr int S = MODE == kLane ? 32 : 1;
  uint32_t* c;
  __device__ __forceinline__ void add(uint32_t d, uint32_t k) const {
    if constexpr (MODE == kLane) {
      c[d * S] += k;
    } else {
      atomicAdd(&c[d], k);
    }
  }
};

// Counts of keys[lo, lo + len) (len a multiple of 4) by this thread's
// vectors: vector v of the unit, keys lo + 4v .. lo + 4v + 3, for v = t,
// t + GT, ...; a run of equal digits adds once.
template <int MODE, int GT, bool VEC>
__device__ __forceinline__ void count_unit(const uint32_t* __restrict__ keys,
                                           long long lo, int len, int t,
                                           int shift, uint32_t mask,
                                           const Counters<MODE>& cnt) {
  const int nvec = len >> 2;
  uint32_t prev = 0, run = 0;   // the first flush adds 0 to counter 0
  auto key = [&](uint32_t k) {
    const uint32_t d = (k >> shift) & mask;
    if (d != prev) {
      cnt.add(prev, run);
      prev = d;
      run = 0;
    }
    ++run;
  };
  for (int v0 = t; v0 < nvec; v0 += 4 * GT) {
    uint4 x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + q * GT;
      if (v < nvec) {
        if constexpr (VEC) {
          x[q] = reinterpret_cast<const uint4*>(keys + lo)[v];
        } else {
          const uint32_t* p = keys + lo + 4 * v;
          x[q] = make_uint4(p[0], p[1], p[2], p[3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (v0 + q * GT < nvec) {
        key(x[q].x);
        key(x[q].y);
        key(x[q].z);
        key(x[q].w);
      }
    }
  }
  cnt.add(prev, run);
}

__device__ __forceinline__ void put(uint32_t* o, uint32_t x, bool whole) {
  if (whole) {
    *o = x;
  } else if (x != 0) {
    atomicAdd(o, x);
  }
}

// Units u = 0 .. units-1, unit u the keys of part u % parts of block
// u / parts; counting group g of the grid takes u = g, g + groups, ...
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinCtas)
block_histograms(const uint32_t* __restrict__ keys,
                 uint32_t* __restrict__ out, long long units,
                 long long block_size, int unit, int parts, int r, int shift,
                 uint32_t mask) {
  extern __shared__ uint32_t sm[];
  constexpr int GT = MODE == kCta ? kThreads : 32;
  constexpr int GPC = kThreads / GT;   // counting groups a CTA
  const int bins = 1 << r;
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x % GT;
  const int group = threadIdx.x / GT;
  uint32_t* gc = sm + group * (MODE == kLane ? bins << 5 : bins);
  const Counters<MODE> cnt{MODE == kLane ? gc + lane : gc};
  // zero the counters: a lane its own column (kLane), else the group's
  if constexpr (MODE == kLane) {
    for (int j = 0; j < bins; ++j) cnt.c[j * 32] = 0;
  } else {
    for (int j = t; j < bins; j += GT) gc[j] = 0;
  }
  if constexpr (MODE == kCta) __syncthreads();
  if constexpr (MODE == kWarp) __syncwarp();
  const long long stride = static_cast<long long>(gridDim.x) * GPC;
  const bool whole = parts == 1;
  for (long long u = static_cast<long long>(blockIdx.x) * GPC + group;
       u < units; u += stride) {
    const long long blk = u / parts;
    const int p = static_cast<int>(u - blk * parts);
    const long long start = static_cast<long long>(p) * unit;
    const int len = static_cast<int>(min(static_cast<long long>(unit),
                                         block_size - start));
    count_unit<MODE, GT, VEC>(keys, blk * block_size + start, len, t, shift,
                              mask, cnt);
    uint32_t* o = out + blk * bins;
    if constexpr (MODE == kLane) {
      // bins <= 32: lane d takes the sum of counter d over the 32 columns
      uint32_t mine = 0;
      for (int j = 0; j < bins; ++j) {
        const uint32_t s = __reduce_add_sync(0xffffffffu, cnt.c[j * 32]);
        cnt.c[j * 32] = 0;
        if (lane == j) mine = s;
      }
      if (lane < bins) put(o + lane, mine, whole);
    } else {
      if constexpr (MODE == kCta) {
        __syncthreads();
      } else {
        __syncwarp();
      }
      for (int j = t; j < bins; j += GT) {
        put(o + j, gc[j], whole);
        gc[j] = 0;
      }
      if constexpr (MODE == kCta) {
        __syncthreads();
      } else {
        __syncwarp();
      }
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

template <int MODE>
cudaError_t launch_shared(const uint32_t* keys, uint32_t* out,
                          long long units, long long block_size, int unit,
                          int parts, int r, int shift, uint32_t mask,
                          cudaStream_t st) {
  constexpr int GPC = MODE == kCta ? 1 : kThreads / 32;
  const size_t smem = (static_cast<size_t>(GPC) * sizeof(uint32_t) << r)
                      * (MODE == kLane ? 32 : 1);
  // one wave of CTAs (kMinCtas an SM), each group walking its units
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  const long long want = (units + GPC - 1) / GPC;
  const long long wave = static_cast<long long>(sms[dev]) * kMinCtas;
  const unsigned grid = static_cast<unsigned>(want < wave ? want : wave);
  if ((reinterpret_cast<uintptr_t>(keys) & 15) == 0) {
    block_histograms<MODE, true><<<grid, kThreads, smem, st>>>(
        keys, out, units, block_size, unit, parts, r, shift, mask);
  } else {
    block_histograms<MODE, false><<<grid, kThreads, smem, st>>>(
        keys, out, units, block_size, unit, parts, r, shift, mask);
  }
  return cudaGetLastError();
}

}  // namespace

// out (n / block_size, 2^r) u32 = per-block counts of digit `group` of the
// n u32 keys. block_size must be a positive multiple of 128 that divides n;
// 0 <= r <= 31. Up to r = 12 the counters live in shared memory, kept as
// `mode` says (kernels/histogram.py `hist_plan`: 0 a column a lane, r <= 4;
// 1 a copy a warp, r = 5..8; 2 a copy a CTA, r = 9..12; any other mode is
// refused), and each block is counted in `parts` units of `unit` keys (a
// multiple of 4; the last may be shorter). Returns a cudaError_t.
extern "C" int lsd_block_histograms(const void* keys, void* out, long long n,
                                    long long block_size, int r, int group,
                                    int mode, int unit, int parts,
                                    void* stream) {
  if (r < 0 || r > 31 || group < 0 || block_size < 128 ||
      block_size % 128 != 0 || block_size > (1LL << 30) ||
      n % block_size != 0) {
    return cudaErrorInvalidValue;
  }
  const long long s = static_cast<long long>(r) * group;
  const int shift = s >= 32 ? 32 : static_cast<int>(s);
  const long long nblocks = n / block_size;
  const auto st = static_cast<cudaStream_t>(stream);
  if (r > kMaxR) {
    if (n == 0) return cudaSuccess;
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
  const int want = r <= kLaneMaxR ? kLane : r <= kWarpMaxR ? kWarp : kCta;
  if (mode != want || unit < 4 ||
      unit % 4 != 0 || parts < 1 ||
      static_cast<long long>(parts - 1) * unit >= block_size ||
      static_cast<long long>(parts) * unit < block_size) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  if (parts > 1) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(nblocks) * sizeof(uint32_t) << r, st);
    if (err != cudaSuccess) return err;
  }
  // a shift of 32 leaves digit 0 (get_digit)
  const uint32_t mask = shift < 32 ? (1u << r) - 1u : 0u;
  const auto* k = static_cast<const uint32_t*>(keys);
  auto* o = static_cast<uint32_t*>(out);
  const long long units = nblocks * parts;
  switch (mode) {
    case kLane:
      return launch_shared<kLane>(k, o, units, block_size, unit, parts, r,
                                  shift & 31, mask, st);
    case kWarp:
      return launch_shared<kWarp>(k, o, units, block_size, unit, parts, r,
                                  shift & 31, mask, st);
    default:
      return launch_shared<kCta>(k, o, units, block_size, unit, parts, r,
                                 shift & 31, mask, st);
  }
}
