// Tiled matrix transpose for Hopper: out (c, r) = x (r, c) transposed.
//
// Replaces the Pallas TPU kernel `transpose_kernel` of
// src/repro/kernels/transpose.py, the ismt workload: each output tile's
// source is a tile one stride away in the transposed direction (a strided
// tile stream), transposed on chip between two dense copies.
//
// What bounds it: bytes.  Every element is read once and written once and
// nothing is computed, so the floor is 2 * r * c * elem_bytes over the
// card's memory rate (0.64 ms for a 16,384 x 16,384 fp32 matrix at
// 3.35 TB/s).
//
// Design: one block of 32 x 8 threads per 32 x 32 tile.  The block reads
// its tile row by row (a warp covers 32 neighbouring elements of one input
// row, so the read is coalesced), stores it in shared memory, and writes
// it out row by row of the output, reading shared memory down a column.
// The shared tile has one column of padding (32 x 33), so the column read
// falls on 32 different banks for 4-byte elements.  The element is a
// template parameter of 1, 2, 4 or 8 bytes and is moved as raw bits, so
// fp32, bf16, fp16, int8 and fp64 all transpose bitwise.  The reference's
// wrapper pads the matrix to a multiple of its block and slices the result;
// here each thread masks the ragged edge of its tile instead, so there is
// neither a padding copy nor a slice.  Tile rows beyond the grid's 65,535
// limit are walked by a loop over the grid's y dimension.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

template <typename T>
__global__ void transpose_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 long long r, long long c) {
  __shared__ T tile[kTile][kTile + 1];
  const long long tiles_r = (r + kTile - 1) / kTile;
  const long long c0 = (long long)blockIdx.x * kTile;
  for (long long ty = blockIdx.y; ty < tiles_r; ty += gridDim.y) {
    const long long r0 = ty * kTile;
    // Read x[r0 + i, c0 + tx] for the tile's rows i.
    const long long col = c0 + threadIdx.x;
    for (int i = threadIdx.y; i < kTile; i += kRowsPerPass) {
      const long long row = r0 + i;
      if (row < r && col < c) tile[i][threadIdx.x] = x[row * c + col];
    }
    __syncthreads();
    // Write out[c0 + i, r0 + tx] = x[r0 + tx, c0 + i].
    const long long ocol = r0 + threadIdx.x;
    for (int i = threadIdx.y; i < kTile; i += kRowsPerPass) {
      const long long orow = c0 + i;
      if (orow < c && ocol < r) out[orow * r + ocol] = tile[threadIdx.x][i];
    }
    __syncthreads();  // the tile is reused by the next pass of the loop
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long r, long long c,
                   cudaStream_t stream) {
  const long long tiles_c = (c + kTile - 1) / kTile;
  const long long tiles_r = (r + kTile - 1) / kTile;
  if (tiles_c > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles_c, (unsigned)(tiles_r > 65535 ? 65535 : tiles_r));
  dim3 block(kTile, kRowsPerPass);
  transpose_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), r, c);
  return cudaGetLastError();
}

}  // namespace

// out (c, r) = x (r, c)^T for contiguous row-major matrices of elem_bytes
// elements (1, 2, 4 or 8); any other element size returns
// cudaErrorInvalidValue without launching.
extern "C" int repro_tiled_transpose(const void* x, void* out, long long r,
                                     long long c, int elem_bytes,
                                     void* stream) {
  if (r <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (elem_bytes) {
    case 1: err = launch<uint8_t>(x, out, r, c, s); break;
    case 2: err = launch<uint16_t>(x, out, r, c, s); break;
    case 4: err = launch<uint32_t>(x, out, r, c, s); break;
    case 8: err = launch<uint64_t>(x, out, r, c, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
