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
// the x DMAs.  One block per row block of the (row_blocks, steps) panel_ids
// table.  Step s of row block b needs the `panel`-wide slice of x at
// panel_ids[b, s] * panel: it is copied into shared memory with cp.async
// (16-byte copies where the panel and x allow, else 4-byte), double
// buffered, so step s+1's slice is in flight while step s gathers from
// shared memory.  Entries of step s are the K/steps columns s*kb .. s*kb +
// kb - 1 of each row; an entry whose column falls outside the step's panel
// contributes zero (masked, not clipped), and each step's partial row sum
// is added to the row's total in step order, as the reference does across
// its grid.  The bytes it must move are vals + cols + y and the panels it
// reads: with several row blocks naming the same panel, x is read more
// than once, and the wrapper's caller can count that from panel_ids.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Dynamic shared memory: two panel buffers (step s uses the one at
// smem + (s & 1) * panel), then the row block's sums.
__global__ void spmv_ell_panel_kernel(const float* __restrict__ vals,
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

int lanes_for(int entries) {
  int g = 1;
  while (g < entries && g < 32) g *= 2;
  return g;
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
// k % steps == 0 and c % panel == 0 are the caller's to check.
extern "C" int repro_spmv_ell_panel(const void* vals, const void* cols,
                                    const void* x, const void* panel_ids,
                                    void* y, long long row_blocks,
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
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spmv_ell_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec16 =
      panel % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int g = lanes_for(k / steps);
  spmv_ell_panel_kernel<<<(unsigned)row_blocks, kThreads, smem, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const float*>(x), static_cast<const int*>(panel_ids),
      static_cast<float*>(y), row_block, k, steps, panel, c / panel, g,
      vec16);
  return static_cast<int>(cudaGetLastError());
}
