// Indirect stream converters for Hopper: packed row gather and scatter.
//
// Replaces the Pallas TPU kernels `indirect_gather_kernel` and
// `indirect_scatter_kernel` of src/repro/kernels/stream_converters.py.
// On the serving path they carry every K/V write: `ops.paged_kv_append`
// scatters one row per sequence per decode step, and
// `ops.paged_kv_write_chunk` gathers each prefill row's page window,
// scatters the chunk into it and writes the touched pages back.
//
// What bounds them: bytes.  A call moves count * row_bytes in and the same
// out and does no arithmetic, so its floor is 2 * count * row_bytes over
// the card's memory rate.  At the serving shapes a call moves a few KB to
// a few hundred KB, so in practice the launch itself dominates.
//
// Design: one block per packed row, which reads its own index (the TPU
// kernel's scalar prefetch becomes one scalar load).  Rows are copied as
// raw bytes, so one kernel serves fp32 pages, int8 pages and fp32 scales;
// where the row length and both base pointers are 16-byte aligned, each
// thread moves 16 bytes per load so that a warp reads 512 contiguous bytes.
// The scatter writes in place.  An index outside [0, n_rows) drops its row:
// the callers send inactive and padding rows there instead of padding the
// pool with a scratch row, which would copy the whole pool.  Duplicate
// in-range indices race; the paged callers never issue them.

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

// The message of a CUDA error code returned by any entry of these libraries.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
