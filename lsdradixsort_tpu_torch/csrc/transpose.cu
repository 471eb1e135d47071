// 2-D transpose for Hopper (sm_90a): tiled, and for narrow matrices.
//
// Replaces the Pallas kernel of lsdradixsort_tpu/kernels/transpose.py:
// transpose_tiled (_tr_kernel). out (cols, rows) = a (rows, cols)
// transposed, for 4-byte elements (u32, i32).
//
// What bounds it on the H100: one read and one write of the matrix. Read
// row by row and written row by row of the output, one side of a naive
// transpose strides through memory. This is the classic shared-memory
// transpose, the reference's TransposeSMEMKernel (LSDRadixSort.cu:512-544):
// a CTA of 32 x 8 threads reads a 32 x 32 tile with coalesced rows into
// shared memory padded by one column (so the column reads hit 32 banks)
// and writes it back transposed, again in coalesced rows. Tiles are
// numbered on a 1-D grid, so a tall matrix (the (2^21, 16) histogram of
// 2^30 keys) stays under the grid's y limit; edge tiles are masked. The
// TPU's `tile` argument is checked for divisibility only, by the wrapper.
//
// A narrow matrix (cols <= 32: the composed sort's (blocks, 2^r)
// histograms at r <= 5) would leave most of each 32 x 32 tile masked off,
// and its bytes are too few to matter: what it costs is the launch and
// one DRAM round trip. transpose_narrow takes it with no shared memory and
// no barrier: a thread owns 4 consecutive input rows and 4 of their
// columns, reads them with 16-byte loads where cols allows (a multiple of
// 4, or 1 or 2, when the 4 rows are cols whole vectors) and 4-byte loads
// otherwise, and writes each column's 4 words out[c * rows + r0 .. + 3] as
// one 16-byte store, so consecutive threads of a column group write on
// along the output row. lsd_transpose takes it when cols <= 32, rows is a
// multiple of 4 and both pointers are 16-byte aligned, and the tiles
// otherwise.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;     // tile side
constexpr int kRows = 8;   // thread rows; each thread moves kT / kRows words

__global__ void __launch_bounds__(kT * kRows)
transpose_tiles(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                long long rows, long long cols, long long tiles_c) {
  __shared__ uint32_t t[kT][kT + 1];
  const long long r0 = blockIdx.x / tiles_c * kT;
  const long long c0 = blockIdx.x % tiles_c * kT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < kT; j += kRows) {
    const long long r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols) t[j][tx] = a[r * cols + c];
  }
  __syncthreads();
  for (int j = ty; j < kT; j += kRows) {
    const long long orow = c0 + j, ocol = r0 + tx;
    if (orow < cols && ocol < rows) out[orow * rows + ocol] = t[tx][j];
  }
}

constexpr int kNarrowCols = 32;
constexpr int kNarrowThreads = 128;

// out (cols, rows) = a (rows, cols) transposed, cols <= kNarrowCols, rows
// % 4 == 0, a and out 16-byte aligned. Thread t takes rows 4 g .. 4 g + 3
// and columns 4 q .. 4 q + 3 (those below cols), with q = t % qn, g = t /
// qn, qn = ceil(cols / 4). C = 0: cols % 4 == 0, a 16-byte load a row;
// C = 1, 2: cols == C, the 4 rows as C 16-byte loads; C = -1: 4-byte loads.
template <int C>
__global__ void __launch_bounds__(kNarrowThreads)
transpose_narrow(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                 long long rows, int cols) {
  const int qn = (cols + 3) >> 2;
  const long long t =
      static_cast<long long>(blockIdx.x) * kNarrowThreads + threadIdx.x;
  const long long g = t / qn;
  const int q = static_cast<int>(t - g * qn);
  if (g >= rows >> 2) return;
  const uint32_t* src = a + 4 * g * cols;  // the thread's 4 rows
  uint32_t w[4][4] = {};                   // w[i][j]: row 4 g + i, col 4 q + j
  if constexpr (C == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(src + i * cols + 4 * q);
      w[i][0] = v.x;
      w[i][1] = v.y;
      w[i][2] = v.z;
      w[i][3] = v.w;
    }
  } else if constexpr (C > 0) {
    uint32_t r[4 * C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[k];
      r[4 * k] = v.x;
      r[4 * k + 1] = v.y;
      r[4 * k + 2] = v.z;
      r[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) w[i][j] = r[i * C + j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * q + j;
        w[i][j] = c < cols ? src[i * cols + c] : 0u;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * q + j;
    if (c < cols) {
      *reinterpret_cast<uint4*>(out + c * rows + 4 * g) =
          make_uint4(w[0][j], w[1][j], w[2][j], w[3][j]);
    }
  }
}

template <int C>
void launch_narrow(const uint32_t* a, uint32_t* out, long long rows,
                   int cols, cudaStream_t st) {
  const long long threads = (rows >> 2) * ((cols + 3) >> 2);
  transpose_narrow<C><<<static_cast<unsigned>(
                            (threads + kNarrowThreads - 1) / kNarrowThreads),
                        kNarrowThreads, 0, st>>>(a, out, rows, cols);
}

}  // namespace

// out (cols, rows) = transpose of a (rows, cols), 4-byte elements, both
// row-major and contiguous, on `device` (made current for the launch) and
// `stream`: transpose_narrow when cols <= 32, rows % 4 == 0 and both
// pointers are 16-byte aligned, else transpose_tiles. Returns a
// cudaError_t.
extern "C" int lsd_transpose(const void* a, void* out, long long rows,
                             long long cols, int device, void* stream) {
  if (rows < 0 || cols < 0) return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const long long tiles_r = (rows + kT - 1) / kT;
  const long long tiles_c = (cols + kT - 1) / kT;
  if (tiles_r * tiles_c > 0x7fffffffLL) return cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const uint32_t* as = static_cast<const uint32_t*>(a);
  uint32_t* os = static_cast<uint32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (cols <= kNarrowCols && rows % 4 == 0 && aligned) {
    const int c = static_cast<int>(cols);
    if (c % 4 == 0) {
      launch_narrow<0>(as, os, rows, c, st);
    } else if (c == 1) {
      launch_narrow<1>(as, os, rows, c, st);
    } else if (c == 2) {
      launch_narrow<2>(as, os, rows, c, st);
    } else {
      launch_narrow<-1>(as, os, rows, c, st);
    }
  } else {
    transpose_tiles<<<static_cast<unsigned>(tiles_r * tiles_c),
                      dim3(kT, kRows), 0, st>>>(as, os, rows, cols, tiles_c);
  }
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}
