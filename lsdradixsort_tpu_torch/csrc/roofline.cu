// The card's read ceiling, for Hopper (sm_90a).
//
// No TPU kernel stands behind this file. core/roofline.py
// `measure_read_gbps` times one launch of read_probe, which reads every
// word of a buffer once and writes one word (their sum mod 2^32): the
// least traffic a kernel that reads a buffer can make. chip_smoke.py puts
// the bytes a kernel reads beyond those it writes (a histogram's keys, a
// compaction's mask) over this rate in its bounds, and the rest over the
// rate of a copy. A library reduction is no measure of it: torch.amax of
// 2^27 int32 words read 2938.7 GB/s on an H100 SXM (700 W), under the
// 3017.6 GB/s of a copy in the same run.
//
// A persistent grid of kCtasPerSm CTAs an SM; each thread keeps kInFlight
// 16-byte loads in flight before it adds them, and a warp adds its sum
// into the output with one atomic.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;       // 2048 threads an SM
constexpr int kInFlight = 4;        // 16-byte loads a thread before it adds

__global__ void __launch_bounds__(kThreads)
read_probe(const uint4* __restrict__ x, long long n16,
           uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t acc = 0;
  for (; i + (kInFlight - 1) * stride < n16; i += kInFlight * stride) {
    uint4 v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) v[k] = __ldg(x + i + k * stride);
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      acc += v[k].x + v[k].y + v[k].z + v[k].w;
    }
  }
  for (; i < n16; i += stride) {
    const uint4 v = __ldg(x + i);
    acc += v.x + v.y + v.z + v.w;
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(out, acc);
}

}  // namespace

// *out += the sum mod 2^32 of the n u32 words at x, each read once. x must
// be 16-byte aligned and n a multiple of 4. Returns a cudaError_t.
extern "C" int lsd_read_probe(const void* x, long long n, void* out,
                              void* stream) {
  if (n < 0 || n % 4 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(sms) * kCtasPerSm;
  const unsigned grid = static_cast<unsigned>(want < wave ? want : wave);
  read_probe<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), n / 4, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}
