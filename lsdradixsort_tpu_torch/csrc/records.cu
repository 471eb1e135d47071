// Gather of whole fixed-width records for Hopper (sm_90a): out[i] =
// in[perm[i]] for rows of R bytes, the last step of sort_records (the row
// movement after the key sort).
//
// Replaces no TPU kernel: the JAX package sorts 32-bit columns and moves
// no row wider than one word (its gathers are jnp `take`s of u32 columns).
// The port's sort_records (ops/sort.py) sorts the records' key words with
// sort_lex and then moves every record once by the permutation; a 1-D
// torch gather would need int64 indices and a view of the rows as one
// element, so the rows move here, by the u32 permutation as it is.
//
// What bounds it on the H100: device-memory bytes. The function reads the
// permutation once (4 bytes a row), each source row once and writes each
// output row once: m * (2R + 4) bytes (10^8 rows of 100 bytes: 20.4 GB,
// 6.09 ms at 3.35 TB/s). The source rows are read in the permutation's
// order, so each row costs whole 32-byte sectors: R = 100 touches 4 or 5.
//
// A CTA copies kRows consecutive output rows: it reads their permutation
// entries once into shared memory (as element offsets), then its threads
// walk the CTA's output as one flat array of elements, thread t taking
// elements t, t + kThreads, ...: neighbouring threads copy neighbouring
// elements of one row (coalesced loads of the source row) and the stores
// are fully coalesced. Each thread keeps kUnroll loads in flight. An
// element is the widest of 16, 8, 4 or 1 bytes that divides R and both
// base addresses (gensort's 100-byte rows: 4-byte words, 25 a row); a
// thread's row and column advance by a fixed step, so no element divides
// by R.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;       // output rows a CTA copies
constexpr int kUnroll = 4;       // loads in flight a thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_records(const T* __restrict__ in, const uint32_t* __restrict__ perm,
               T* __restrict__ out, long long m, int width) {
  __shared__ long long src[kRows];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        m - r0));
  for (int r = threadIdx.x; r < rows; r += kThreads)
    src[r] = static_cast<long long>(perm[r0 + r]) * width;
  __syncthreads();
  const int total = rows * width;
  const int step_r = kThreads / width;
  const int step_c = kThreads - step_r * width;
  T* dst = out + r0 * width;
  int k = threadIdx.x;
  int r = k / width;
  int c = k - r * width;
  while (k < total) {
    T v[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = k;
      if (k < total) v[u] = in[src[r] + c];
      k += kThreads;
      r += step_r;
      c += step_c;
      if (c >= width) {
        c -= width;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (at[u] < total) dst[at[u]] = v[u];
    }
  }
}

template <typename T>
int launch(const void* in, const void* perm, void* out, long long m,
           long long width_bytes, cudaStream_t stream) {
  const long long blocks = (m + kRows - 1) / kRows;
  gather_records<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<const uint32_t*>(perm),
      static_cast<T*>(out), m, static_cast<int>(width_bytes / sizeof(T)));
  return cudaGetLastError();
}

}  // namespace

// out (m, width_bytes) = in[perm] for rows of width_bytes bytes; perm is m
// u32 row indices into in, each below in's row count (not checked here).
// Returns a cudaError_t.
extern "C" int lsd_gather_records(const void* in, const void* perm, void* out,
                                  long long m, long long width_bytes,
                                  void* stream) {
  if (m < 0 || m > 0x7fffffffLL || width_bytes < 0 ||
      width_bytes * kRows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (m == 0 || width_bytes == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t base =
      reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  const auto fits = [&](long long size) {
    return width_bytes % size == 0 && base % size == 0;
  };
  if (fits(16)) return launch<uint4>(in, perm, out, m, width_bytes, s);
  if (fits(8)) return launch<uint2>(in, perm, out, m, width_bytes, s);
  if (fits(4)) return launch<uint32_t>(in, perm, out, m, width_bytes, s);
  return launch<uint8_t>(in, perm, out, m, width_bytes, s);
}
