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
// the read-only path and the 50 MB L2, which holds x whole up to 12.5 M
// columns; rows whose columns are close share x's sectors in L2.
//
// spmv_ell, design: the matrix is a stream and x is a working set.  At
// the workload's size (2**22 rows, K = 32, ~24 live entries a row) vals
// and cols are 1.07 GB read once, and x is 16 MB gathered ~100 M times,
// one 32-byte L2 sector a live entry: ~3.2 GB of L2 sector traffic beside
// the 1.1 GB from device memory, so the x gathers, not the stream, set the
// time.  Measured on the H100 (tools/spmv_ab.py): with the columns cut to
// 2**20 and 2**18 distinct entries the same stream runs 3% and 9% faster,
// so x's misses in L2 cost little and its sector rate the most.  An
// evict-last L2 policy on x gained nothing there, and more gathers in
// flight a lane (4 lanes a row, two 16-byte loads of cols each before any
// gather) ran slower.  So the design keeps the stream out of the way and
// the loads whole:
//  - vals and cols are read once, as a stream: 16-byte loads with the
//    evict-first (streaming) cache operator, so they do not push x out of
//    L1 and the 50 MB L2;
//  - x goes through the read-only path (__ldg) and L2, no policy;
//  - lanes a row are sized so that each lane has one load of the row (8
//    at K = 32): a warp's load reads four whole 128-byte rows of vals and
//    of cols, and each lane's 4 gathers are independent.
// The plan (kernels/plans.py SpmvPlan: entries a load `vec`, `lanes` a
// row, threads, blocks) is chosen on the host from K and the alignment
// and launched as given: 4 entries a load where K is a multiple of 4 and
// vals and cols are 16-byte aligned, else 1; lanes the smallest power of
// two that gives each load its own lane, at most 32.  Load i of a row
// (entries i*vec .. i*vec + vec - 1) belongs to lane i % lanes.  A column
// is clamped to [0, C-1] (the reference's take(mode='clip')); rows past R
// are masked, so R needs no padding to the reference's row_block.
// Summation order: each lane adds its entries in load order, entries of a
// load in order; then a tree over the lanes (shuffles down by lanes/2, ..,
// 1).  The plain version sums the row in torch's order, so the two agree
// to fp32 rounding.
//
// spmv_ell_panel, design: the paper's indirect stream descriptor driving
// the x copies.  The first design ran one block per row block of the
// (row_blocks, steps) panel_ids table, double-buffered 2 KB panels with
// cp.async and waited on each, while vals and cols went through L1/L2 with
// no hint: latency-bound at 45% of its bytes bound.  Now a block owns a
// tile of rows (kernels/plans.py PanelPlan: `pack` whole row blocks, or a
// part of one when a row block is too large for shared memory) and stages
// everything it needs at
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

// y[row] for rows of the ELL matrix by the plan: `lanes` lanes a row, V
// entries a load (see the design note above).
template <int V>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_kernel(const float* __restrict__ vals,
                    const int* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ y,
                    long long r, int k, int c, int lanes) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = tid / lanes;
  const int lane = (int)(tid % lanes);
  float acc = 0.f;
  if (row < r) {
    const long long off = row * k;
    if (V == 4) {
      const float4* v4 = reinterpret_cast<const float4*>(vals + off);
      const int4* c4 = reinterpret_cast<const int4*>(cols + off);
      for (int i = lane; i < k / 4; i += lanes) {
        const float4 v = __ldcs(v4 + i);
        const int4 cc = __ldcs(c4 + i);
        acc += v.x * gather_clip(x, cc.x, c);
        acc += v.y * gather_clip(x, cc.y, c);
        acc += v.z * gather_clip(x, cc.z, c);
        acc += v.w * gather_clip(x, cc.w, c);
      }
    } else {
      for (int i = lane; i < k; i += lanes) {
        acc += __ldcs(vals + off + i) *
               gather_clip(x, __ldcs(cols + off + i), c);
      }
    }
  }
  // Every lane of the warp takes part in the shuffles, masked rows too.
  for (int s = lanes / 2; s > 0; s /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, s, lanes);
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
// clamped to [0, c-1], by the host's plan (kernels/plans.py SpmvPlan),
// taken as given: `vec` entries a load (4 or 1), `lanes` lanes a row (a
// power of two up to 32), `blocks` blocks of `threads` (256) threads.
extern "C" int repro_spmv_ell(const void* vals, const void* cols,
                              const void* x, void* y, long long r, int k,
                              int c, int vec, int lanes, int threads,
                              long long blocks, void* stream) {
  if (r <= 0) return static_cast<int>(cudaGetLastError());
  if (threads != kThreads || blocks <= 0 || blocks > 0x7fffffffLL ||
      (vec != 4 && vec != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vec == 4 ? &spmv_ell_kernel<4> : &spmv_ell_kernel<1>;
  kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const float*>(x), static_cast<float*>(y), r, k, c, lanes);
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
