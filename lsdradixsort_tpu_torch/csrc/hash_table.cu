// Hash-table probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel of lsdradixsort_tpu/kernels/hash_table.py:
// probe_table (_probe_kernel). The table is the JAX package's layout: 128
// lane buckets of `rows` chain slots, as (rows, 128) u32 key and value
// planes and a (1, 128) chain-length row; a key k lives in lane
// (k * 0x9E3779B1 mod 2^32) >> 25. For each probe key: match = 1 and
// val = the slot's value if some slot r < min(cnt[lane], rows) of its lane
// holds it (the last such slot wins), else (0, 0). With semi, val is 0.
//
// The TPU kernel holds the table in VMEM and, for each (512, 128) block of
// probes, lane-gathers every chain row of both planes: 1 + 2 * rows
// 128-wide gathers, whatever the chains' lengths. On the card each thread
// probes its own keys and walks only its lane's chain: cnt[lane] slots.
// The table is staged in shared memory when it fits (cnt, the key plane
// and, unless semi, the value plane: 512 + 512 * rows * planes bytes, up to
// the card's opt-in limit, about 220 rows for a join); a larger table is
// read from device memory through L1/L2 by the same code. Blocks loop over
// the probes (grid = the blocks that fit on the card at once), so the
// staging is paid once a block, not once a tile.
//
// What bounds it on the H100: device-memory bytes, 4 read and 8 written a
// probe, for a table in shared memory; a chain of c slots costs c
// shared-memory loads a probe. A table past shared memory costs c L1/L2
// loads a probe, which bound it instead.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr uint32_t kMix = 0x9E3779B1u;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
probe(const uint32_t* __restrict__ tk, const uint32_t* __restrict__ tv,
      const uint32_t* __restrict__ cnt, const uint32_t* __restrict__ keys,
      uint32_t* __restrict__ om, uint32_t* __restrict__ ov, long long n,
      int rows, bool semi) {
  extern __shared__ uint32_t table[];
  const uint32_t* c = cnt;
  const uint32_t* k = tk;
  const uint32_t* v = tv;
  if (kShared) {
    uint32_t* sc = table;
    uint32_t* sk = table + kLanes;
    uint32_t* sv = sk + rows * kLanes;
    for (int i = threadIdx.x; i < kLanes; i += kThreads) sc[i] = cnt[i];
    for (int i = threadIdx.x; i < rows * kLanes; i += kThreads) {
      sk[i] = tk[i];
      if (!semi) sv[i] = tv[i];
    }
    __syncthreads();
    c = sc;
    k = sk;
    v = sv;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t x = keys[i];
    const int lane = static_cast<int>((x * kMix) >> 25);
    const int len = min(static_cast<int>(min(c[lane], 0x7fffffffu)), rows);
    uint32_t m = 0, bv = 0;
    for (int r = 0; r < len; ++r) {
      const int at = r * kLanes + lane;
      if (k[at] == x) {
        m = 1u;
        if (!semi) bv = v[at];
      }
    }
    om[i] = m;
    ov[i] = bv;
  }
}

template <bool kShared>
cudaError_t launch(const uint32_t* tk, const uint32_t* tv, const uint32_t* cnt,
                   const uint32_t* keys, uint32_t* om, uint32_t* ov,
                   long long n, int rows, bool semi, size_t smem,
                   cudaStream_t st) {
  cudaError_t err;
  if (kShared) {
    err = cudaFuncSetAttribute(probe<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe<kShared>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < fit ? need : fit);
  probe<kShared><<<grid, kThreads, smem, st>>>(tk, tv, cnt, keys, om, ov, n,
                                                rows, semi);
  return cudaGetLastError();
}

}  // namespace

// Probe n u32 keys against the (rows, 128) table planes tk, tv and the 128
// chain lengths cnt: om[i] = match (0/1), ov[i] = the value (0 when
// unmatched, always 0 when semi). Returns a cudaError_t.
extern "C" int lsd_probe_table(const void* tk, const void* tv, const void* cnt,
                               const void* keys, void* om, void* ov,
                               long long n, int rows, int semi, void* stream) {
  if (n < 0 || rows < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t planes = semi ? 1 : 2;
  const size_t smem = (kLanes + planes * static_cast<size_t>(rows) * kLanes) *
                      sizeof(uint32_t);
  const auto* a = static_cast<const uint32_t*>(tk);
  const auto* b = static_cast<const uint32_t*>(tv);
  const auto* c = static_cast<const uint32_t*>(cnt);
  const auto* k = static_cast<const uint32_t*>(keys);
  auto* m = static_cast<uint32_t*>(om);
  auto* v = static_cast<uint32_t*>(ov);
  const auto st = static_cast<cudaStream_t>(stream);
  if (smem <= static_cast<size_t>(optin)) {
    return launch<true>(a, b, c, k, m, v, n, rows, semi != 0, smem, st);
  }
  return launch<false>(a, b, c, k, m, v, n, rows, semi != 0, 0, st);
}
