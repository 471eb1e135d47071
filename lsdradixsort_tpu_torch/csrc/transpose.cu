// Tiled 2-D transpose for Hopper (sm_90a).
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

}  // namespace

// out (cols, rows) = transpose of a (rows, cols), 4-byte elements, both
// row-major and contiguous. Returns a cudaError_t.
extern "C" int lsd_transpose(const void* a, void* out, long long rows,
                             long long cols, void* stream) {
  if (rows < 0 || cols < 0) return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const long long tiles_r = (rows + kT - 1) / kT;
  const long long tiles_c = (cols + kT - 1) / kT;
  if (tiles_r * tiles_c > 0x7fffffffLL) return cudaErrorInvalidValue;
  transpose_tiles<<<static_cast<unsigned>(tiles_r * tiles_c), dim3(kT, kRows),
                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out), rows, cols,
      tiles_c);
  return cudaGetLastError();
}
