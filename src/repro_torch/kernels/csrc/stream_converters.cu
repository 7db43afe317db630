// Stream converters for Hopper: packed row gather and scatter, indirect
// and strided.
//
// Replaces the Pallas TPU kernels `indirect_gather_kernel`,
// `indirect_scatter_kernel`, `strided_gather_kernel` and
// `strided_scatter_kernel` of src/repro/kernels/stream_converters.py.
// The indirect pair is the reference's general converter (MoE dispatch
// and combine use it); the serving path's K/V writes go through
// `repro_paged_kv_write` below, one launch a layer, which replaces the
// scatter and the page window of the reference's paged writes.  The
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
// Design, indirect gather: rows are copied as raw bytes, so one kernel
// serves fp32 pages, int8 pages and fp32 scales, and the index is clipped
// to [0, n_rows) (the reference's take(mode='clip')).  A 2-D grid,
// gathered row by slab of the row, in one launch: each thread copies one
// unit a pass, so a block of 256 threads moves a 4 KB slab of 16-byte
// units and 24 rows of 32 KB spread over 192 blocks with every unit in
// flight at once (one block per row, the first design, put 24 blocks on
// 132 SMs, each thread with eight dependent 16-byte round trips).  The
// plan (unit, slab, threads, grid) is chosen on the host from the row
// length and the pointers' alignment (kernels/plans.py) and launched as
// given: 16-byte units where the row length and both base pointers allow,
// else 4-byte, else 1-byte, so any width (e.g. 4099 bytes) copies bitwise.
// A TMA bulk copy through shared memory (one thread a slab, on an
// mbarrier) ran slower than these register copies at every row length
// tried on the H100, 256 B to 64 KB, so the gather does not use it.
//
// Design, indirect scatter: one block per packed row, which reads its own
// index (the TPU kernel's scalar prefetch becomes one scalar load); where
// the row length and both base pointers are 16-byte aligned, each thread
// moves 16 bytes per load so that a warp reads 512 contiguous bytes.  The
// scatter writes in place.  An index outside [0, n_rows) drops its row:
// the callers send inactive and padding rows there instead of padding the
// pool with a scratch row, which would copy the whole pool.  Duplicate
// in-range indices race.
//
// Design, paged K/V write (`repro_paged_kv_write`): replaces
// `indirect_scatter_kernel` (stream_converters.py:170) on the serving path
// and the page window of src/repro/kernels/ops.py:489
// (`paged_kv_write_chunk`: gather the W pages a chunk touches, scatter the
// chunk into them, scatter the pages back) and of `paged_kv_append`.  The
// window exists because a TPU DMA moves whole blocks; here a warp stores
// one token row anywhere, so the write touches only the token rows, as the
// full-pool oracle does.  A call writes ~2 KB to ~260 KB, so what bounds it
// is the launch itself, then the bytes of the new rows in and the pool rows
// out over the card's memory rate: on the paged steps, which are host-bound,
// the window's 6 launches a layer (12 with int8 pools) and its ~25 small
// tensor ops of index math cost more host time than any body.  So one
// launch a layer writes every valid token of the call, K and V, codes and
// scales: warp w owns the row (token, K or V, kv head) with the kv head
// fastest, so neighbouring warps store neighbouring bytes; at D = 128 a
// lane moves one float4.  Each warp computes its destination as the oracle
// does: pos = starts[r] + c (an append passes lengths as starts, active as
// counts and C = 1); the row is dropped where c >= counts[r], pos lies
// outside [0, n_pages * page) or the table's page id outside [0, P);
// else it lands in row pid * page + pos % page.  int8 pools quantize on
// the way, bitwise with ref.quantize_kv: amax over D by warp shuffles (a
// max is exact in any order), scale = amax > 0 ? amax * (1.0f / 127.0f)
// : 1 (the reference's amax / 127.0 as XLA compiles it under jax.jit, a
// multiply by the float reciprocal; ref.int8_quantize writes the same on
// every device), and code = clamp(rint(x / scale), -127, 127), an IEEE
// division (the build has no fast-math), rint rounding half to even as
// torch.round does.  bf16 pools round each fp32 element once, to nearest
// even (__float2bfloat16_rn, as Tensor.to(torch.bfloat16) and XLA's
// convert), and a lane stores two elements a 4-byte store.
// Repeated destinations have no defined order; the paged callers never
// repeat one.
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

#include <cuda_bf16.h>
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

__device__ __forceinline__ long long clip_row(const int* __restrict__ idx,
                                              long long n_rows) {
  const long long r = idx[blockIdx.x];
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);  // take(mode='clip')
}

// Gather: block (k, y) copies slabs y, y + gridDim.y, ... of gathered row
// k, `slab` bytes each, in units of U (16, 4 or 1 bytes); with the plan's
// slab of blockDim.x units each thread copies one unit a slab.  Indices
// within a row are 32-bit (the plan caps a row at 2**30 units).  This loop
// form measured faster on the H100 than a flat grid-stride loop over the
// row's units, with a 64-bit or a 32-bit index.
template <typename U>
__global__ void indirect_gather_kernel(const char* __restrict__ src,
                                       const int* __restrict__ idx,
                                       char* __restrict__ out,
                                       long long n_rows, long long row_bytes,
                                       int slab, int slabs) {
  const U* s = reinterpret_cast<const U*>(src + clip_row(idx, n_rows) *
                                                    row_bytes);
  U* d = reinterpret_cast<U*>(out + (long long)blockIdx.x * row_bytes);
  const int row_units = (int)(row_bytes / (long long)sizeof(U));
  const int slab_units = slab / (int)sizeof(U);
  for (int j = blockIdx.y; j < slabs; j += gridDim.y) {
    const int lo = j * slab_units;
    const int hi = min(lo + slab_units, row_units);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) d[i] = s[i];
  }
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

// The paged K/V write (see the design note above): one warp per (token,
// K|V, kv head) row of d floats, V floats a load (4 where d and every
// base pointer allow, else 1), stored as E-byte pool elements: 4 fp32,
// 2 bf16, 1 int8 codes with a scale.
constexpr int kWriteThreads = 256;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int V, int E>
__global__ void __launch_bounds__(kWriteThreads)
    paged_kv_write_kernel(const float* __restrict__ k_new,
                          const float* __restrict__ v_new,
                          void* __restrict__ k_pages,
                          void* __restrict__ v_pages,
                          float* __restrict__ k_scale,
                          float* __restrict__ v_scale,
                          const int* __restrict__ table,
                          const int* __restrict__ starts,
                          const int* __restrict__ counts, long long warps,
                          int chunk, int n_pages, int pool_pages, int page,
                          int kvh, int d) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= warps) return;  // whole warps: w is uniform over the warp
  const int h = (int)(w % kvh);
  const long long t = w / kvh;
  const int is_v = (int)(t % 2);
  const long long token = t / 2;  // r * chunk + c
  const int c = (int)(token % chunk);
  const long long r = token / chunk;
  const int start = starts[r];
  const int count = counts[r];
  const long long pos = (long long)start + c;
  if (c >= count || pos < 0 || pos >= (long long)n_pages * page) return;
  const int pid = table[r * n_pages + pos / page];
  if (pid < 0 || pid >= pool_pages) return;
  const long long row = ((long long)pid * page + pos % page) * kvh + h;
  const float* src = (is_v ? v_new : k_new) + (token * kvh + h) * d;
  if constexpr (E == 2) {
    __nv_bfloat16* dst =
        static_cast<__nv_bfloat16*>(is_v ? v_pages : k_pages) + row * d;
    for (int e = lane * V; e < d; e += 32 * V) {
      if constexpr (V == 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + e);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst + e);
        o[0] = __floats2bfloat162_rn(x.x, x.y);
        o[1] = __floats2bfloat162_rn(x.z, x.w);
      } else {
        dst[e] = __float2bfloat16_rn(src[e]);
      }
    }
  } else if constexpr (E == 4) {
    float* dst = static_cast<float*>(is_v ? v_pages : k_pages) + row * d;
    for (int e = lane * V; e < d; e += 32 * V) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst + e) =
            *reinterpret_cast<const float4*>(src + e);
      } else {
        dst[e] = src[e];
      }
    }
  } else {
    float amax = 0.f;
    for (int e = lane * V; e < d; e += 32 * V) {
      float x[V];
      load_vec<V>(src + e, x);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int s = 16; s > 0; s /= 2) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
    }
    const float scale = amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;
    signed char* dst =
        static_cast<signed char*>(is_v ? v_pages : k_pages) + row * d;
    for (int e = lane * V; e < d; e += 32 * V) {
      float x[V];
      load_vec<V>(src + e, x);
      signed char q[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        q[i] = (signed char)fminf(fmaxf(rintf(x[i] / scale), -127.f), 127.f);
      }
      if constexpr (V == 4) {
        *reinterpret_cast<char4*>(dst + e) = make_char4(q[0], q[1], q[2], q[3]);
      } else {
        dst[e] = q[0];
      }
    }
    if (lane == 0) (is_v ? v_scale : k_scale)[row] = scale;
  }
}

template <int V, int E>
cudaError_t launch_paged_kv_write(const void* k_new, const void* v_new,
                                  void* k_pages, void* v_pages,
                                  void* k_scale, void* v_scale,
                                  const void* table, const void* starts,
                                  const void* counts, long long warps,
                                  int chunk, int n_pages, int pool_pages,
                                  int page, int kvh, int d, cudaStream_t s) {
  const long long per_block = kWriteThreads / 32;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  paged_kv_write_kernel<V, E><<<(unsigned)blocks, kWriteThreads, 0, s>>>(
      static_cast<const float*>(k_new), static_cast<const float*>(v_new),
      k_pages, v_pages, static_cast<float*>(k_scale),
      static_cast<float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      warps, chunk, n_pages, pool_pages, page, kvh, d);
  return cudaGetLastError();
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

// out[k] = src[clip(idx[k])] for k < count; rows of row_bytes bytes, by
// the host's plan (kernels/plans.py GatherPlan), taken as given: `unit`
// bytes a copy (16, 4 or 1; it divides row_bytes and both pointers),
// `slabs` slabs of `slab` bytes a row, grid (count, grid_y) of `threads`
// threads.
extern "C" int repro_indirect_gather(const void* src, const void* idx,
                                     void* out, long long n_rows,
                                     long long count, long long row_bytes,
                                     int unit, int slab, int slabs,
                                     int grid_y, int threads, void* stream) {
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((unsigned)count, (unsigned)grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const char* a = static_cast<const char*>(src);
  const int* i = static_cast<const int*>(idx);
  char* o = static_cast<char*>(out);
  if (unit == 16) {
    indirect_gather_kernel<int4><<<grid, threads, 0, s>>>(
        a, i, o, n_rows, row_bytes, slab, slabs);
  } else if (unit == 4) {
    indirect_gather_kernel<int><<<grid, threads, 0, s>>>(
        a, i, o, n_rows, row_bytes, slab, slabs);
  } else {
    indirect_gather_kernel<char><<<grid, threads, 0, s>>>(
        a, i, o, n_rows, row_bytes, slab, slabs);
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

// Every valid token of a chunk (or an append) into its page, K and V, in
// one launch.  k_new, v_new (rows, chunk, kvh, d) fp32; pools (pool_pages,
// page, kvh, d) of elem_bytes elements: 4 fp32, 2 bf16, 1 int8 codes with
// (pool_pages, page, kvh) fp32 scales; table (rows, n_pages), starts,
// counts (rows,) int32.  Token (r, c) goes to position starts[r] + c through table row r,
// and is dropped where c >= counts[r] or the position or its page id is
// out of range.
// `vec` 4: d % 4 == 0 and every row pointer allows 16-byte fp32 loads
// (and 8-byte bf16 or 4-byte code stores); else 1.
extern "C" int repro_paged_kv_write(const void* k_new, const void* v_new,
                                    void* k_pages, void* v_pages,
                                    void* k_scale, void* v_scale,
                                    const void* table, const void* starts,
                                    const void* counts, long long rows,
                                    int chunk, int n_pages, int pool_pages,
                                    int page, int kvh, int d, int elem_bytes,
                                    int vec, void* stream) {
  const long long warps = rows * chunk * 2 * kvh;
  if (warps <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t (*launch)(const void*, const void*, void*, void*, void*,
                        void*, const void*, const void*, const void*,
                        long long, int, int, int, int, int, int,
                        cudaStream_t);
  switch (elem_bytes) {
    case 4:
      launch = vec == 4 ? &launch_paged_kv_write<4, 4>
                        : &launch_paged_kv_write<1, 4>;
      break;
    case 2:
      launch = vec == 4 ? &launch_paged_kv_write<4, 2>
                        : &launch_paged_kv_write<1, 2>;
      break;
    case 1:
      launch = vec == 4 ? &launch_paged_kv_write<4, 1>
                        : &launch_paged_kv_write<1, 1>;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch(k_new, v_new, k_pages, v_pages, k_scale,
                                 v_scale, table, starts, counts, warps,
                                 chunk, n_pages, pool_pages, page, kvh, d,
                                 static_cast<cudaStream_t>(stream)));
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
