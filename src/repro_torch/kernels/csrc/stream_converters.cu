// Stream converters for Hopper: packed row gather and scatter, indirect
// and strided.
//
// Replaces the Pallas TPU kernels `indirect_gather_kernel`,
// `indirect_scatter_kernel`, `strided_gather_kernel` and
// `strided_scatter_kernel` of src/repro/kernels/stream_converters.py.
// On the serving path the indirect pair carries every K/V write:
// `ops.paged_kv_append` scatters one row per sequence per decode step, and
// `ops.paged_kv_write_chunk` gathers each prefill row's page window,
// scatters the chunk into it and writes the touched pages back.  The
// strided pair carries the recurrent state pools: one sequence's state in
// a (layers, batch, *row) pool is rows slot, slot + batch, ... of the flat
// (layers * batch, row) view, so `ops.recurrent_state_write` (every
// admission's replay) and `ops.recurrent_state_read` are one strided burst
// each, with base = slot, stride = batch and count = layers.
//
// What bounds them: bytes.  A call moves count * row_bytes in and the same
// out and does no arithmetic, so its floor is 2 * count * row_bytes over
// the card's memory rate.  The paged calls move a few KB to a few hundred
// KB, so the launch itself dominates; a recurrent state burst moves up to
// 32 rows of 640 KB (rwkv6-3b's wkv state), where the copy rate matters.
//
// Design, indirect: one block per packed row, which reads its own index
// (the TPU kernel's scalar prefetch becomes one scalar load).  Rows are
// copied as raw bytes, so one kernel serves fp32 pages, int8 pages and fp32
// scales; where the row length and both base pointers are 16-byte aligned,
// each thread moves 16 bytes per load so that a warp reads 512 contiguous
// bytes.  The scatter writes in place.  An index outside [0, n_rows) drops
// its row: the callers send inactive and padding rows there instead of
// padding the pool with a scratch row, which would copy the whole pool.
// Duplicate in-range indices race; the paged callers never issue them.
//
// Design, strided: there is no index memory at all.  base, stride and count
// are launch arguments and each block computes its row's address from them
// (the descriptor is the whole address, the AXI-Pack strided burst).  A
// 2-D grid, packed row by slab of the row, so that a few very wide rows
// still spread over the SMs.  The copy unit is 16 bytes where the row
// length and both base pointers allow it, else 4 bytes, else 1 byte, so any
// row width and any dtype copy bitwise.  The gather clips a row outside
// [0, n_rows) to the nearest row (the reference's take(mode='clip')); the
// scatter drops it.  The scatter writes in place: that replaces the TPU
// kernel's input_output_aliases, and the reference's 128-lane row padding
// and pack_rows tail split have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         long long row_bytes, bool vec16) {
  if (vec16) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += blockDim.x) {
      d[i] = s[i];
    }
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) {
      dst[i] = src[i];
    }
  }
}

__global__ void indirect_gather_kernel(const char* __restrict__ src,
                                       const int* __restrict__ idx,
                                       char* __restrict__ out,
                                       long long n_rows, long long row_bytes,
                                       bool vec16) {
  const long long k = blockIdx.x;
  long long r = idx[k];
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);  // clip, as take(mode=clip)
  copy_row(out + k * row_bytes, src + r * row_bytes, row_bytes, vec16);
}

__global__ void indirect_scatter_kernel(char* __restrict__ dst,
                                        const char* __restrict__ packed,
                                        const int* __restrict__ idx,
                                        long long n_rows, long long row_bytes,
                                        bool vec16) {
  const long long k = blockIdx.x;
  const long long r = idx[k];
  if (r < 0 || r >= n_rows) return;  // out of range: the row is dropped
  copy_row(dst + r * row_bytes, packed + k * row_bytes, row_bytes, vec16);
}

bool aligned16(const void* a, const void* b, long long row_bytes) {
  return row_bytes % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          16) == 0;
}

// Rows of one strided burst, as units of U (16, 4 or 1 bytes).
constexpr int kStridedThreads = 256;
constexpr int kUnitsPerThread = 4;

template <typename U, bool kScatter>
__global__ void strided_kernel(U* __restrict__ dst, const U* __restrict__ src,
                               long long n_rows, long long base,
                               long long stride, long long row_units) {
  const long long k = blockIdx.x;  // packed row
  long long r = base + k * stride;  // strided row
  if (kScatter) {
    if (r < 0 || r >= n_rows) return;  // out of range: the row is dropped
  } else {
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);  // clip
  }
  const U* s = src + (kScatter ? k : r) * row_units;
  U* d = dst + (kScatter ? r : k) * row_units;
  const long long step = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       i < row_units; i += step) {
    d[i] = s[i];
  }
}

template <typename U, bool kScatter>
cudaError_t launch_strided(void* dst, const void* src, long long n_rows,
                           long long base, long long stride, long long count,
                           long long row_bytes, cudaStream_t stream) {
  const long long units = row_bytes / (long long)sizeof(U);
  const long long per_block = (long long)kStridedThreads * kUnitsPerThread;
  long long slabs = (units + per_block - 1) / per_block;
  slabs = slabs > 65535 ? 65535 : slabs;
  dim3 grid((unsigned)count, (unsigned)slabs);
  strided_kernel<U, kScatter><<<grid, kStridedThreads, 0, stream>>>(
      static_cast<U*>(dst), static_cast<const U*>(src), n_rows, base, stride,
      units);
  return cudaGetLastError();
}

template <bool kScatter>
int strided(void* dst, const void* src, long long n_rows, long long base,
            long long stride, long long count, long long row_bytes,
            void* stream) {
  if (count <= 0 || row_bytes <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t m = reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src) |
                      static_cast<uintptr_t>(row_bytes);
  cudaError_t err;
  if (m % 16 == 0) {
    err = launch_strided<int4, kScatter>(dst, src, n_rows, base, stride,
                                         count, row_bytes, s);
  } else if (m % 4 == 0) {
    err = launch_strided<int, kScatter>(dst, src, n_rows, base, stride, count,
                                        row_bytes, s);
  } else {
    err = launch_strided<char, kScatter>(dst, src, n_rows, base, stride,
                                         count, row_bytes, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// out[k] = src[idx[k]] for k < count; rows of row_bytes bytes.
extern "C" int repro_indirect_gather(const void* src, const void* idx,
                                     void* out, long long n_rows,
                                     long long count, long long row_bytes,
                                     void* stream) {
  if (count > 0 && row_bytes > 0) {
    indirect_gather_kernel<<<(unsigned)count, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char*>(src), static_cast<const int*>(idx),
        static_cast<char*>(out), n_rows, row_bytes,
        aligned16(src, out, row_bytes));
  }
  return static_cast<int>(cudaGetLastError());
}

// dst[idx[k]] = packed[k] for k < count, in place; idx outside [0, n_rows)
// drops the row.
extern "C" int repro_indirect_scatter(void* dst, const void* packed,
                                      const void* idx, long long n_rows,
                                      long long count, long long row_bytes,
                                      void* stream) {
  if (count > 0 && row_bytes > 0) {
    indirect_scatter_kernel<<<(unsigned)count, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<char*>(dst), static_cast<const char*>(packed),
        static_cast<const int*>(idx), n_rows, row_bytes,
        aligned16(dst, packed, row_bytes));
  }
  return static_cast<int>(cudaGetLastError());
}

// out[k] = src[clip(base + k * stride)] for k < count; rows of row_bytes.
extern "C" int repro_strided_gather(const void* src, void* out,
                                    long long n_rows, long long base,
                                    long long stride, long long count,
                                    long long row_bytes, void* stream) {
  return strided<false>(out, src, n_rows, base, stride, count, row_bytes,
                        stream);
}

// dst[base + k * stride] = packed[k] for k < count, in place; a row outside
// [0, n_rows) is dropped.  Rows that repeat (stride 0) race.
extern "C" int repro_strided_scatter(void* dst, const void* packed,
                                     long long n_rows, long long base,
                                     long long stride, long long count,
                                     long long row_bytes, void* stream) {
  return strided<true>(dst, packed, n_rows, base, stride, count, row_bytes,
                       stream);
}

// The message of a CUDA error code returned by any entry of these libraries.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
