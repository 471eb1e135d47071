// Run shuffles for Hopper (sm_90a): copies of runs of rows or words to new
// offsets, the data movement of a radix scatter.
//
// Replaces the Pallas kernels of lsdradixsort_tpu/kernels/shuffle.py:
//  * shuffle_row_runs (_shuffle_kernel, _shuffle_kernel_pipelined): for each
//    run i, out[dst[i] : dst[i] + len_i] = x[src[i] : src[i] + len_i] in whole
//    128-word (512-byte) rows;
//  * shuffle_elem_runs (_shuffle_elem_kernel): the same on 4-byte words.
//
// The TPU moves each run with DMAs whose shapes must be static: fixed-size
// runs as one DMA each, variable runs decomposed by binary weight, one DMA
// per set bit 0..mb of the length. So only the low mb + 1 bits of a length
// are copied: a run of length ln copies its words [ln & ~keep, ln), keep =
// 2^(mb+1) - 1, at that same offset within the run. Both kernels reproduce
// that: `keep` is the wrapper's mask (all ones past the top bit where
// nothing is cut), and with `fixed` > 0 every run copies exactly `fixed`
// items, whatever its length says, as the TPU's fixed-size path does.
//
// A run is clipped to both buffers: no word before the start or past the
// end of x or out is read or written (the TPU leaves such runs undefined;
// interpret mode clamps the slice start instead). Destination runs must be
// disjoint for a defined result; output words that no run covers keep
// whatever the buffer held.
//
// What bounds it on the H100: device-memory bytes, each copied word read
// once and written once. A CTA of 256 threads copies one run with a
// block-stride loop, four 16-byte loads in flight a thread: rows are always
// 512-byte aligned, and word runs whose source and destination agree mod 16
// bytes copy a scalar head and tail around a 16-byte body. One CTA a run
// starves the SMs when a few runs are long; a balanced split of the runs
// into fixed-size chunks (or TMA bulk copies) is the next step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kRowVecs = 128 / 4;    // 16-byte vectors in a row

struct Span {
  long long src, dst, n;    // first item read, first item written, items
};

// The items run i copies: the truncated, clipped run.
__device__ Span clip_run(long long i, const int* __restrict__ src,
                         const int* __restrict__ dst,
                         const int* __restrict__ len, int fixed,
                         long long keep, long long in_items,
                         long long out_items) {
  long long s = src[i], d = dst[i], n;
  if (fixed > 0) {
    n = fixed;
  } else {
    const long long ln = len[i] > 0 ? len[i] : 0;
    const long long skip = ln & ~keep;    // the bits the TPU never copies
    s += skip;
    d += skip;
    n = ln - skip;
  }
  long long lo = 0;
  if (-s > lo) lo = -s;
  if (-d > lo) lo = -d;
  long long hi = n;
  if (in_items - s < hi) hi = in_items - s;
  if (out_items - d < hi) hi = out_items - d;
  if (hi < lo) hi = lo;
  return {s + lo, d + lo, hi - lo};
}

// b[0, n) = a[0, n) by the whole block, kUnroll loads in flight a thread:
// T is uint4 (16-byte vectors) or uint32_t (words).
template <typename T>
__device__ __forceinline__ void copy_vecs(const T* __restrict__ a,
                                          T* __restrict__ b, long long n) {
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < n; i += kUnroll * kThreads) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = a[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) b[i + u * kThreads] = v[u];
  }
  for (; i < n; i += kThreads) b[i] = a[i];
}

__global__ void __launch_bounds__(kThreads)
shuffle_rows(const uint4* __restrict__ x, uint4* __restrict__ out,
             const int* __restrict__ src, const int* __restrict__ dst,
             const int* __restrict__ len, int fixed, long long keep,
             long long in_rows, long long out_rows) {
  const Span r = clip_run(blockIdx.x, src, dst, len, fixed, keep, in_rows,
                          out_rows);
  copy_vecs(x + r.src * kRowVecs, out + r.dst * kRowVecs, r.n * kRowVecs);
}

__global__ void __launch_bounds__(kThreads)
shuffle_elems(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              const int* __restrict__ src, const int* __restrict__ dst,
              const int* __restrict__ len, long long keep, long long in_elems,
              long long out_elems) {
  const Span r = clip_run(blockIdx.x, src, dst, len, 0, keep, in_elems,
                          out_elems);
  const uint32_t* a = x + r.src;
  uint32_t* b = out + r.dst;
  long long n = r.n;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  if (((pa ^ pb) & 15) == 0 && n >= 8) {
    // scalar head up to the 16-byte boundary, vector body, scalar tail
    const long long head = ((16 - (pa & 15)) & 15) / 4;
    if (threadIdx.x < head) b[threadIdx.x] = a[threadIdx.x];
    a += head;
    b += head;
    n -= head;
    const long long vecs = n / 4;
    copy_vecs(reinterpret_cast<const uint4*>(a), reinterpret_cast<uint4*>(b),
              vecs);
    const long long t = vecs * 4 + threadIdx.x;
    if (t < n) b[t] = a[t];
    return;
  }
  copy_vecs(a, b, n);
}

}  // namespace

// Row runs of a (in_rows, 128) u32 x into a (out_rows, 128) u32 out: one
// CTA a run, nruns runs described by int32 src, dst and len (row units).
// fixed > 0: every run copies fixed rows (len is not read); else a run
// copies its rows [len & ~keep, len). x and out must be 16-byte aligned.
// Returns a cudaError_t.
extern "C" int lsd_shuffle_row_runs(const void* x, void* out, const void* src,
                                    const void* dst, const void* len,
                                    long long nruns, long long fixed,
                                    long long keep, long long in_rows,
                                    long long out_rows, void* stream) {
  if (nruns < 0 || nruns > 0x7fffffffLL || fixed < 0 || fixed > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  if (nruns == 0) return cudaSuccess;
  shuffle_rows<<<static_cast<unsigned>(nruns), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out),
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(len), static_cast<int>(fixed), keep, in_rows,
      out_rows);
  return cudaGetLastError();
}

// Word runs of a (in_elems,) u32 x into a (out_elems,) u32 out, any offsets:
// a run copies its words [len & ~keep, len). Returns a cudaError_t.
extern "C" int lsd_shuffle_elem_runs(const void* x, void* out, const void* src,
                                     const void* dst, const void* len,
                                     long long nruns, long long keep,
                                     long long in_elems, long long out_elems,
                                     void* stream) {
  if (nruns < 0 || nruns > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (nruns == 0) return cudaSuccess;
  shuffle_elems<<<static_cast<unsigned>(nruns), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(len), keep, in_elems, out_elems);
  return cudaGetLastError();
}
