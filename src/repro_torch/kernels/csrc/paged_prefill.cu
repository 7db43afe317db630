// Paged prefill attention for Hopper: causal chunk attention straight from
// the page pool.
//
// Replaces the Pallas TPU kernel `paged_prefill_attention_kernel` (body
// `_prefill_body`) of src/repro/kernels/paged_prefill.py, and runs once per
// layer per prefill chunk.
//
// What it computes: q (R, C, H, D) fp32, where row r's query c sits at
// position starts[r] + c; k/v pools (P, page, KVH, D), fp32 or int8 codes
// with (P, page, KVH) fp32 scales; ctx_rows (R, ctx_pages) int32 leading
// page-table entries; starts, counts (R,) int32.  Query c sees kv positions
// p with p <= starts + c and p < starts + counts; the mask uses the finite
// sentinel -1e30, and rows with counts == 0 give exact zeros.
//
// What bounds it: at the serving shapes (chunk 32, rep 8), each context
// token read from the pool feeds 2 * C * rep * D multiply-adds per kv head,
// so this kernel has enough arithmetic per byte to be bound by operations,
// not bytes; in this first version it runs on the fp32 FMA units, whose
// peak is 67 TFLOP/s, not on the tensor cores.
//
// Design: one block per (row, kv head, tile of query positions).  A tile
// holds tq positions times the rep query heads of the kv head's group (64
// query rows), so each K/V page loaded into shared memory serves 64 queries.
// The block walks the row's context pages up to the last position its tile
// can see, min(starts + c_end, starts + counts), so no page past the
// written context is read; int8 codes are dequantized right after the load.
// Online fp32 softmax per query row, with the running max, running sum and
// accumulator in shared memory; K rows carry a one-float pad so the warp
// that scores 16 tokens reads 16 banks.  Rows that are fully masked so far
// keep m = -1e30 and add nothing (rescale factor exp(0) = 1, weights 0), so
// a query's result does not depend on the tile it rides in.
//
// Later work: the products run as scalar FMAs.  wgmma on tiles gathered
// from several small pages, TMA loads and bf16 pools are the way to the
// tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;      // query rows (positions x rep) per block
constexpr float kNegInf = -1e30f;  // the finite mask sentinel

template <typename T>
__global__ void paged_prefill_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ ctx_rows,
    const int* __restrict__ starts, const int* __restrict__ counts,
    float* __restrict__ out, int C, int H, int KVH, int D, int page,
    int ctx_pages, int tq, float scale) {
  extern __shared__ float smem[];
  const int c0 = blockIdx.x * tq;
  const int g = blockIdx.y;
  const int r = blockIdx.z;
  const int rep = H / KVH;
  const int nq = min(tq, C - c0);
  const int rows = nq * rep;  // query row e = cq * rep + head-in-group
  const int Dp = D + 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const int tile_rows = tq * rep;
  float* q_s = smem;                   // tile_rows * D
  float* acc = q_s + tile_rows * D;    // tile_rows * D
  float* k_s = acc + tile_rows * D;    // page * (D + 1)
  float* v_s = k_s + page * Dp;        // page * D
  float* p_s = v_s + page * D;         // tile_rows * page
  float* m_s = p_s + tile_rows * page; // tile_rows
  float* l_s = m_s + tile_rows;        // tile_rows
  float* a_s = l_s + tile_rows;        // tile_rows

  const int st = starts[r];
  const int cnt = counts[r];
  const int live = cnt > 0 ? st + cnt : 0;
  // Kv positions any query of this tile can see: p < min(st + c0 + nq, live).
  const int hi = min(st + c0 + nq, live);
  const int n_walk = hi > 0 ? min((hi + page - 1) / page, ctx_pages) : 0;

  for (int e = tid; e < rows * D; e += nt) {
    const int row = e / D;
    const int i = e - row * D;
    const int cq = row / rep;
    const int hr = row - cq * rep;
    q_s[e] = q[(((size_t)r * C + c0 + cq) * H + (size_t)g * rep + hr) * D + i];
    acc[e] = 0.f;
  }
  for (int e = tid; e < rows; e += nt) {
    m_s[e] = kNegInf;
    l_s[e] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < n_walk; ++j) {
    const size_t pid = (size_t)ctx_rows[(size_t)r * ctx_pages + j];
    const int valid = min(page, hi - j * page);
    for (int e = tid; e < valid * D; e += nt) {
      const int t = e / D;
      const int i = e - t * D;
      const size_t tok = pid * page + t;
      const size_t off = (tok * KVH + g) * D + i;
      float kv = static_cast<float>(k_pages[off]);
      float vv = static_cast<float>(v_pages[off]);
      if (k_scale != nullptr) {
        kv *= k_scale[tok * KVH + g];
        vv *= v_scale[tok * KVH + g];
      }
      k_s[t * Dp + i] = kv;
      v_s[t * D + i] = vv;
    }
    __syncthreads();
    for (int e = tid; e < rows * page; e += nt) {
      const int row = e / page;
      const int t = e - row * page;
      const int qpos = st + c0 + row / rep;
      const int kpos = j * page + t;
      float s = kNegInf;
      if (t < valid && kpos <= qpos) {
        const float* qr = q_s + row * D;
        const float* kt = k_s + t * Dp;
        float dot = 0.f;
        for (int i = 0; i < D; ++i) dot = fmaf(qr[i], kt[i], dot);
        s = dot * scale;
      }
      p_s[e] = s;
    }
    __syncthreads();
    for (int row = tid; row < rows; row += nt) {
      float* pr = p_s + row * page;
      const int qpos = st + c0 + row / rep;
      const float m_old = m_s[row];
      float m_new = m_old;
      for (int t = 0; t < valid; ++t) m_new = fmaxf(m_new, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const bool seen = t < valid && j * page + t <= qpos;
        const float p = seen ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      l_s[row] = l_s[row] * alpha + sum;
      m_s[row] = m_new;
      a_s[row] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < rows * D; e += nt) {
      const int row = e / D;
      const int i = e - row * D;
      const float* pr = p_s + row * page;
      float a = acc[e] * a_s[row];
      for (int t = 0; t < valid; ++t) a = fmaf(pr[t], v_s[t * D + i], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * D; e += nt) {
    const int row = e / D;
    const int i = e - row * D;
    const int cq = row / rep;
    const int hr = row - cq * rep;
    const float l = l_s[row];
    out[(((size_t)r * C + c0 + cq) * H + (size_t)g * rep + hr) * D + i] =
        acc[e] / (l == 0.f ? 1.f : l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* ctx_rows, const void* starts,
           const void* counts, void* out, int R, int C, int H, int KVH, int D,
           int page, int ctx_pages, float scale, cudaStream_t stream) {
  const int rep = H / KVH;
  const int tq = rep >= kTileRows ? 1 : kTileRows / rep;
  const size_t tile_rows = (size_t)tq * rep;
  const size_t smem =
      sizeof(float) * (2 * tile_rows * D + (size_t)page * (2 * D + 1) +
                       tile_rows * page + 3 * tile_rows);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((C + tq - 1) / tq, KVH, R);
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(ctx_rows),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<float*>(out), C, H, KVH, D, page, ctx_pages, tq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// quantized != 0: k/v hold int8 codes and ks/vs the fp32 scale pools;
// otherwise k/v are fp32 and ks/vs are ignored.
extern "C" int repro_paged_prefill(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* ctx_rows, const void* starts,
                                   const void* counts, void* out, int R, int C,
                                   int H, int KVH, int D, int page,
                                   int ctx_pages, float scale, int quantized,
                                   void* stream) {
  if (R == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return launch<int8_t>(q, k, v, ks, vs, ctx_rows, starts, counts, out, R, C,
                          H, KVH, D, page, ctx_pages, scale, s);
  }
  return launch<float>(q, k, v, nullptr, nullptr, ctx_rows, starts, counts,
                       out, R, C, H, KVH, D, page, ctx_pages, scale, s);
}
