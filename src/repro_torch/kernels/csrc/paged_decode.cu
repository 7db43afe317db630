// Paged decode attention for Hopper: one query token per sequence against
// the page pool.
//
// Replaces the Pallas TPU kernel `paged_decode_attention_kernel` (body
// `_paged_body`) of src/repro/kernels/paged_decode.py, and runs once per
// layer per decode step.
//
// What it computes: q (B, H, D) fp32; k/v pools (P, page, KVH, D), fp32 or
// int8 codes with (P, page, KVH) fp32 scales; page_table (B, n_pages) int32;
// lengths (B,) int32.  Head h attends with kv head h / (H / KVH) over the
// sequence's first lengths[b] tokens; online fp32 softmax; length 0 gives
// exact zeros.
//
// What bounds it: bytes.  Each live K/V token is read once per kv head
// (2 * D * elem bytes plus its scales) and feeds 2 * rep * D multiply-adds,
// rep = H / KVH = 8 at yi-6b, so it runs at about 1 to 2 flops per byte,
// far below the card's ratio: the floor is the live cache's bytes over the
// memory rate.
//
// Design: one block per (sequence, kv head).  The block reads the page ids
// from the table itself and walks exactly ceil(len / page) pages, so pages
// past the sequence's end are never read (the TPU kernel's scalar prefetch
// and clamped index map).  Each page's K and V rows for the block's kv head
// are loaded once, dequantized right after the load (code * scale per
// token and kv head), and shared by all rep query heads of the group.  K
// rows sit in shared memory with a one-float pad, so the threads of a warp
// that score 16 tokens read 16 different banks.  The softmax statistics
// (running max m, running sum l) and the output accumulator stay in shared
// memory for the whole walk; the output is acc / l, with l = 0 (empty
// sequence) giving zeros.
//
// Known limit: at yi-6b and B = 8 this launches only 32 blocks on 132 SMs.
// Splitting each page walk across blocks with a combine pass
// (flash-decoding) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the finite mask sentinel

template <typename T>
__global__ void paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ out, int H, int KVH,
    int D, int page, int n_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / KVH;
  const int Dp = D + 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float* q_s = smem;              // rep * D
  float* acc = q_s + rep * D;     // rep * D
  float* k_s = acc + rep * D;     // page * (D + 1)
  float* v_s = k_s + page * Dp;   // page * D
  float* p_s = v_s + page * D;    // rep * page: scores, then weights
  float* m_s = p_s + rep * page;  // rep
  float* l_s = m_s + rep;         // rep
  float* a_s = l_s + rep;         // rep: this page's rescale factor

  int len = lengths[b];
  len = len < 0 ? 0 : (len > n_pages * page ? n_pages * page : len);
  const int n_walk = (len + page - 1) / page;

  const float* qb = q + ((size_t)b * H + (size_t)g * rep) * D;
  for (int e = tid; e < rep * D; e += nt) {
    q_s[e] = qb[e];
    acc[e] = 0.f;
  }
  for (int r = tid; r < rep; r += nt) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < n_walk; ++j) {
    const size_t pid = (size_t)page_table[(size_t)b * n_pages + j];
    const int valid = min(page, len - j * page);
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
    for (int e = tid; e < rep * page; e += nt) {
      const int r = e / page;
      const int t = e - r * page;
      float s = kNegInf;
      if (t < valid) {
        const float* qr = q_s + r * D;
        const float* kt = k_s + t * Dp;
        float dot = 0.f;
        for (int i = 0; i < D; ++i) dot = fmaf(qr[i], kt[i], dot);
        s = dot * scale;
      }
      p_s[e] = s;
    }
    __syncthreads();
    for (int r = tid; r < rep; r += nt) {
      float* pr = p_s + r * page;
      const float m_old = m_s[r];
      float m_new = m_old;
      for (int t = 0; t < valid; ++t) m_new = fmaxf(m_new, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = t < valid ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < rep * D; e += nt) {
      const int r = e / D;
      const int i = e - r * D;
      const float* pr = p_s + r * page;
      float a = acc[e] * a_s[r];
      for (int t = 0; t < valid; ++t) a = fmaf(pr[t], v_s[t * D + i], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)b * H + (size_t)g * rep) * D;
  for (int e = tid; e < rep * D; e += nt) {
    const float l = l_s[e / D];
    ob[e] = acc[e] / (l == 0.f ? 1.f : l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths, void* out,
           int B, int H, int KVH, int D, int page, int n_pages, float scale,
           cudaStream_t stream) {
  const int rep = H / KVH;
  const size_t smem =
      sizeof(float) * ((size_t)2 * rep * D + (size_t)page * (2 * D + 1) +
                       (size_t)rep * page + 3 * (size_t)rep);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, KVH);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), H, KVH, D,
      page, n_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// quantized != 0: k/v hold int8 codes and ks/vs the fp32 scale pools;
// otherwise k/v are fp32 and ks/vs are ignored.
extern "C" int repro_paged_decode(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* table, const void* lengths,
                                  void* out, int B, int H, int KVH, int D,
                                  int page, int n_pages, float scale,
                                  int quantized, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return launch<int8_t>(q, k, v, ks, vs, table, lengths, out, B, H, KVH, D,
                          page, n_pages, scale, s);
  }
  return launch<float>(q, k, v, nullptr, nullptr, table, lengths, out, B, H,
                       KVH, D, page, n_pages, scale, s);
}
