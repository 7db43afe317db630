// Sparse matrix-vector products over padded ELL for Hopper.
//
// Replaces the Pallas TPU kernels `spmv_ell_kernel` and
// `spmv_ell_panel_kernel` of src/repro/kernels/spmv.py: the spmv, prank
// and sssp indirect workloads.  A row r of the (R, K) ELL matrix holds K
// values and K column indices; y[r] = sum_k vals[r, k] * x[cols[r, k]].
//
// What bounds them: bytes.  Each nonzero moves one fp32 value and one
// int32 index and costs two flops, so at 8 bytes per 2 flops the card's
// memory rate is the limit by far: the floor is
// (R*K*(4 + 4) + C*4 + R*4) bytes over 3.35 TB/s.  The irregular part is
// the gather x[cols]: on the TPU x sits whole in VMEM and the gather runs
// there.  On the H100 x stays in device memory and its gather goes through
// the read-only path (__ldg) and the 50 MB L2, which holds x whole up to
// 12.5 M columns; rows whose columns are close share x's sectors in L2.
//
// spmv_ell, design: a group of G threads per row, G a power of two sized to
// the row (K / 4 lanes for the vectorized path, up to 32), so a warp serves
// 32 / G rows.  Where K is a multiple of 4 and both matrices are 16-byte
// aligned, each lane loads four values and four indices with one 16-byte
// load each, so a warp reads 512 contiguous bytes of vals and of cols and
// has four independent x gathers in flight per lane; else each lane loads
// one 4-byte value and index per step.  A column is clamped to [0, C-1]
// (the reference's take(mode='clip')).  The lane partial sums are reduced
// with warp shuffles.  Rows past R are masked, so R needs no padding to
// the reference's row_block.  Summation order: each lane sums its own
// entries (k = lane*V + j + i*G*V), then a tree over the lanes; the plain
// version sums the row in torch's order, so the two agree to fp32 rounding.
//
// spmv_ell_panel, design: the paper's indirect stream descriptor driving
// the x copies.  The first design (kept below as repro_spmv_ell_panel_
// before) ran one block per row block of the (row_blocks, steps)
// panel_ids table, double-buffered 2 KB panels with cp.async and waited on
// each, while vals and cols went through L1/L2 with no hint: latency-bound
// at 45% of its bytes bound.  Now a block owns a tile of rows (kernels/
// plans.py PanelPlan: `pack` whole row blocks, or a part of one when a row
// block is too large for shared memory) and stages everything it needs at
// once: every step's x panel of its row blocks (panel_ids[b, s], clamped
// to x's panels) and the tile's vals and cols, then computes from shared
// memory.  Eight such blocks of ~25 KB fit on an SM, so ~200 KB per SM are
// in flight and the stream, not the latency, sets the time.  Routes:
//  - bulk: warp 0 issues one TMA 1-D bulk copy per region on one mbarrier,
//    vals and cols with an evict-first L2 policy (read once) and the
//    panels evict-last (x is re-read by every row block naming a panel);
//  - cp.async: every thread copies with cp.async, 16 bytes where a region
//    allows it and 4 elsewhere, for an x, vals or cols that is not 16-byte
//    aligned, or a panel or tile that is not a multiple of 16 bytes.
// Entries of step s are the K/steps columns s*kb .. s*kb + kb - 1 of each
// row; an entry whose column falls outside the step's panel contributes
// zero (masked, not clipped); one thread sums a (row, step) pair, and a
// row's step sums are added in step order, as the reference does across
// its grid.  The bytes it must move are vals + cols + y and the panels it
// reads: with several row blocks naming the same panel, x is read more
// than once (from L2), and the wrapper's caller can count that from
// panel_ids.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gather_clip(const float* __restrict__ x,
                                             int col, int c) {
  col = col < 0 ? 0 : (col >= c ? c - 1 : col);
  return __ldg(x + col);
}

// y[row] for rows of the ELL matrix; G lanes per row, V entries per load.
template <int V>
__global__ void spmv_ell_kernel(const float* __restrict__ vals,
                                const int* __restrict__ cols,
                                const float* __restrict__ x,
                                float* __restrict__ y, long long r, int k,
                                int c, int g) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = tid / g;
  const int lane = (int)(tid % g);
  float acc = 0.f;
  if (row < r) {
    const long long off = row * k;
    if (V == 4) {
      const float4* v4 = reinterpret_cast<const float4*>(vals + off);
      const int4* c4 = reinterpret_cast<const int4*>(cols + off);
      for (int i = lane; i < k / 4; i += g) {
        const float4 v = __ldg(v4 + i);
        const int4 cc = __ldg(c4 + i);
        acc += v.x * gather_clip(x, cc.x, c);
        acc += v.y * gather_clip(x, cc.y, c);
        acc += v.z * gather_clip(x, cc.z, c);
        acc += v.w * gather_clip(x, cc.w, c);
      }
    } else {
      for (int i = lane; i < k; i += g) {
        acc += __ldg(vals + off + i) * gather_clip(x, __ldg(cols + off + i), c);
      }
    }
  }
  // Every lane of the warp takes part in the shuffles, masked rows too.
  for (int s = g / 2; s > 0; s /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, s, g);
  }
  if (row < r && lane == 0) y[row] = acc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void load_panel(float* dst, const float* x,
                                           int pid, int n_panels, int panel,
                                           bool vec16) {
  pid = pid < 0 ? 0 : (pid >= n_panels ? n_panels - 1 : pid);
  const float* src = x + (long long)pid * panel;
  if (vec16) {
    for (int i = threadIdx.x; i < panel / 4; i += blockDim.x) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < panel; i += blockDim.x) {
      cp_async4(dst + i, src + i);
    }
  }
  asm volatile("cp.async.commit_group;\n");
}

// The panel kernel's first design, kept for comparison on the card
// (repro_spmv_ell_panel_before); no caller of the port uses it.  Dynamic
// shared memory: two panel buffers (step s uses the one at smem + (s & 1) *
// panel), then the row block's sums.
__global__ void panel_before_kernel(const float* __restrict__ vals,
                                    const int* __restrict__ cols,
                                    const float* __restrict__ x,
                                    const int* __restrict__ panel_ids,
                                    float* __restrict__ y, int row_block,
                                    int k, int steps, int panel,
                                    int n_panels, int g, bool vec16) {
  extern __shared__ float smem[];
  float* ysum = smem + 2 * panel;
  const long long rb = blockIdx.x;
  const int* pids = panel_ids + rb * steps;
  const int kb = k / steps;
  const int rows_per_pass = blockDim.x / g;
  const int lane = threadIdx.x % g;
  for (int i = threadIdx.x; i < row_block; i += blockDim.x) ysum[i] = 0.f;
  load_panel(smem, x, pids[0], n_panels, panel, vec16);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_panel(smem + ((s + 1) & 1) * panel, x, pids[s + 1], n_panels, panel,
                 vec16);
    } else {
      asm volatile("cp.async.commit_group;\n");  // an empty group
    }
    asm volatile("cp.async.wait_group 1;\n");  // step s's panel has landed
    __syncthreads();
    const float* xs = smem + (s & 1) * panel;
    int pid = pids[s];
    pid = pid < 0 ? 0 : (pid >= n_panels ? n_panels - 1 : pid);
    const int base = pid * panel;
    for (int r0 = 0; r0 < row_block; r0 += rows_per_pass) {
      const int row = r0 + threadIdx.x / g;
      float acc = 0.f;
      if (row < row_block) {
        const long long off = (rb * row_block + row) * k + (long long)s * kb;
        for (int e = lane; e < kb; e += g) {
          const int local = __ldg(cols + off + e) - base;
          if (local >= 0 && local < panel) acc += __ldg(vals + off + e) * xs[local];
        }
      }
      for (int d = g / 2; d > 0; d /= 2) {
        acc += __shfl_down_sync(0xffffffffu, acc, d, g);
      }
      if (row < row_block && lane == 0) ysum[row] += acc;
    }
    __syncthreads();  // this buffer is refilled at step s + 2
  }
  for (int i = threadIdx.x; i < row_block; i += blockDim.x) {
    y[rb * row_block + i] = ysum[i];
  }
}

__device__ __forceinline__ int clamp_panel(int pid, int n_panels) {
  return pid < 0 ? 0 : (pid >= n_panels ? n_panels - 1 : pid);
}

// `bytes` (a multiple of 4) from global `src` into shared `dst` with
// cp.async by every thread: 16-byte copies where both addresses and the
// length allow, else 4-byte.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const uintptr_t m = (uintptr_t)hopper::smem_u32(dst) |
                      reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes;
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  if (m % 16 == 0) {
    for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) {
      cp_async16(d + i, g + i);
    }
  } else {
    for (int i = threadIdx.x * 4; i < bytes; i += blockDim.x * 4) {
      cp_async4(d + i, g + i);
    }
  }
}

// The panel SpMV (see the design note above).  Shared memory, each region
// 16-byte aligned: the panels [row block of the tile][step][panel], the
// tile's vals and cols (row-major, as in device memory), one partial sum
// per (row, step), then the mbarrier.
template <bool kBulk>
__global__ void __launch_bounds__(256)
    spmv_ell_panel_kernel(const float* __restrict__ vals,
                          const int* __restrict__ cols,
                          const float* __restrict__ x,
                          const int* __restrict__ panel_ids,
                          float* __restrict__ y, long long row_blocks,
                          int row_block, int k, int steps, int panel,
                          int n_panels, int tile, int pack, int split,
                          int panels_bytes, int vals_bytes, int part_bytes) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  unsigned char* sm = tile_smem;
  float* xs = reinterpret_cast<float*>(sm);
  float* vs = reinterpret_cast<float*>(sm + panels_bytes);
  int* cs = reinterpret_cast<int*>(sm + panels_bytes + vals_bytes);
  float* part = reinterpret_cast<float*>(sm + panels_bytes + 2 * vals_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + panels_bytes +
                                              2 * vals_bytes + part_bytes);

  // The tile: rows [r0, r0 + nrows), spanning nrb row blocks from rb0.
  const long long group = blockIdx.x / split;
  const int rel0 = (int)(blockIdx.x % split) * tile;  // row in row block rb0
  const long long rb0 = group * pack;
  const long long r0 = rb0 * row_block + rel0;
  const long long end =
      (rb0 + pack < row_blocks ? rb0 + pack : row_blocks) * row_block;
  const int nrows = (int)(end - r0 < tile ? end - r0 : tile);
  const int nrb = (rel0 + nrows - 1) / row_block + 1;
  const int n_pan = nrb * steps;
  const int* pids = panel_ids + rb0 * steps;
  const long long off = r0 * k;
  const int tile_bytes = nrows * k * 4;
  const int panel_bytes = panel * 4;

  if (kBulk) {
    if (threadIdx.x == 0) {
      hopper::mbar_init(bar, 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        hopper::mbar_expect_tx(bar, 2 * tile_bytes + n_pan * panel_bytes);
      }
      __syncwarp();
      const uint64_t once = hopper::policy_evict_first();
      const uint64_t keep = hopper::policy_evict_last();
      if (threadIdx.x == 0) {
        hopper::bulk_load_hint(vs, vals + off, tile_bytes, bar, once);
      } else if (threadIdx.x == 1) {
        hopper::bulk_load_hint(cs, cols + off, tile_bytes, bar, once);
      }
      for (int p = threadIdx.x; p < n_pan; p += 32) {
        const float* src =
            x + (long long)clamp_panel(pids[p], n_panels) * panel;
        hopper::bulk_load_hint(xs + (long long)p * panel, src, panel_bytes,
                               bar, keep);
      }
    }
    hopper::mbar_wait(bar, 0);
  } else {
    copy_async(vs, vals + off, tile_bytes);
    copy_async(cs, cols + off, tile_bytes);
    const bool vec = panel % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int unit = vec ? 4 : 1;  // floats per copy
    const int per_panel = panel / unit;
    for (int i = threadIdx.x; i < n_pan * per_panel; i += blockDim.x) {
      const int p = i / per_panel;
      const int e = (i - p * per_panel) * unit;
      const float* src =
          x + (long long)clamp_panel(pids[p], n_panels) * panel + e;
      if (vec) {
        cp_async16(xs + (long long)p * panel + e, src);
      } else {
        cp_async4(xs + (long long)p * panel + e, src);
      }
    }
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  // One thread per (row, step): the step's masked sum over its kb entries.
  const int kb = k / steps;
  for (int i = threadIdx.x; i < nrows * steps; i += blockDim.x) {
    const int r = i / steps;
    const int st = i - r * steps;
    const int rb = (rel0 + r) / row_block;  // row block within the tile
    const int base = clamp_panel(pids[rb * steps + st], n_panels) * panel;
    const float* xp = xs + (long long)(rb * steps + st) * panel;
    const float* v = vs + r * k + st * kb;
    const int* c = cs + r * k + st * kb;
    float acc = 0.f;
    if (kb % 4 == 0) {
      for (int j = 0; j < kb; j += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(v + j);
        const int4 cc = *reinterpret_cast<const int4*>(c + j);
        const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
        const int ce[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // Unsigned: a column below the panel wraps to a large offset.
          const unsigned local = (unsigned)ce[u] - (unsigned)base;
          if (local < (unsigned)panel) acc += ve[u] * xp[local];
        }
      }
    } else {
      for (int j = 0; j < kb; ++j) {
        const unsigned local = (unsigned)c[j] - (unsigned)base;
        if (local < (unsigned)panel) acc += v[j] * xp[local];
      }
    }
    part[i] = acc;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    float t = 0.f;
    for (int st = 0; st < steps; ++st) t += part[r * steps + st];
    y[r0 + r] = t;
  }
}

int lanes_for(int entries) {
  int g = 1;
  while (g < entries && g < 32) g *= 2;
  return g;
}

template <bool kBulk>
cudaError_t launch_panel(const void* vals, const void* cols, const void* x,
                         const void* panel_ids, void* y,
                         long long row_blocks, int row_block, int k,
                         int steps, int panel, int c, int tile, int pack,
                         int split, int blocks, int panels_bytes,
                         int vals_bytes, int part_bytes, int smem,
                         cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spmv_ell_panel_kernel<kBulk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  spmv_ell_panel_kernel<kBulk><<<(unsigned)blocks, kThreads, (size_t)smem,
                                 s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const float*>(x), static_cast<const int*>(panel_ids),
      static_cast<float*>(y), row_blocks, row_block, k, steps, panel,
      c / panel, tile, pack, split, panels_bytes, vals_bytes, part_bytes);
  return cudaGetLastError();
}

}  // namespace

// y (r,) = ELL (vals, cols) (r, k) @ x (c,), fp32 values, int32 columns
// clamped to [0, c-1].
extern "C" int repro_spmv_ell(const void* vals, const void* cols,
                              const void* x, void* y, long long r, int k,
                              int c, void* stream) {
  if (r <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      k % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(cols)) %
       16) == 0;
  const int g = lanes_for(vec4 ? k / 4 : k);
  const long long blocks = (r * g + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (vec4) {
    spmv_ell_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(cols),
        static_cast<const float*>(x), static_cast<float*>(y), r, k, c, g);
  } else {
    spmv_ell_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(cols),
        static_cast<const float*>(x), static_cast<float*>(y), r, k, c, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// Panel-streamed SpMV: row block b (row_block rows) gathers step s's
// entries from x's panel panel_ids[b, s] (clamped to [0, c/panel - 1]);
// entries outside that panel are masked.  r = row_blocks * row_block,
// k % steps == 0 and c % panel == 0 are the caller's to check.  The launch
// follows the host's plan (kernels/plans.py PanelPlan), taken as given:
// route 0 = bulk, 1 = cp.async; `blocks` tiles of `tile` rows (`pack` row
// blocks, or 1/`split` of one), `smem` bytes of dynamic shared memory laid
// out as panels, vals, cols and step partials of the given sizes.
extern "C" int repro_spmv_ell_panel(const void* vals, const void* cols,
                                    const void* x, const void* panel_ids,
                                    void* y, long long row_blocks,
                                    int row_block, int k, int steps,
                                    int panel, int c, int route, int tile,
                                    int pack, int split, int blocks,
                                    int panels_bytes, int vals_bytes,
                                    int part_bytes, int smem, void* stream) {
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      route == 0
          ? launch_panel<true>(vals, cols, x, panel_ids, y, row_blocks,
                               row_block, k, steps, panel, c, tile, pack,
                               split, blocks, panels_bytes, vals_bytes,
                               part_bytes, smem, s)
          : launch_panel<false>(vals, cols, x, panel_ids, y, row_blocks,
                                row_block, k, steps, panel, c, tile, pack,
                                split, blocks, panels_bytes, vals_bytes,
                                part_bytes, smem, s);
  return static_cast<int>(err);
}

// The panel kernel's first design: one block per row block, two panels
// double-buffered with cp.async.  For comparison on the card only.
extern "C" int repro_spmv_ell_panel_before(const void* vals,
                                           const void* cols, const void* x,
                                           const void* panel_ids, void* y,
                                           long long row_blocks,
                                           int row_block, int k, int steps,
                                           int panel, int c, void* stream) {
  if (row_blocks <= 0 || row_block <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (steps <= 0 || k % steps != 0 || panel <= 0 || c % panel != 0 ||
      row_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (2 * (size_t)panel + row_block) * sizeof(float);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        panel_before_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec16 =
      panel % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int g = lanes_for(k / steps);
  panel_before_kernel<<<(unsigned)row_blocks, kThreads, smem, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const float*>(x), static_cast<const int*>(panel_ids),
      static_cast<float*>(y), row_block, k, steps, panel, c / panel, g,
      vec16);
  return static_cast<int>(cudaGetLastError());
}
