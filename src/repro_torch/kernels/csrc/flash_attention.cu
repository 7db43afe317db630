// Flash attention for Hopper: the training path's forward, forward with
// log-sum-exp, and two-pass backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_attention_kernel      (kernel 8: o, for attention with no grad)
//   flash_attention_fwd_kernel  (kernel 9: o and lse, saved for backward)
//   flash_attention_bwd_kernel  (kernel 10: the dk/dv pass `_dkv_body` and
//                                the dq pass `_dq_body`)
// Every layer of a training step runs kernel 9 (twice under remat: the
// forward and its recompute) and kernel 10 once; attention under no_grad
// runs kernel 8.
//
// What they compute: q (B, H, Sq, D); k, v (B, KVH, Skv, D); query head h
// reads KV head h / (H / KVH); query i sits at position i.  Each (b, head)
// slice is addressed through element strides (b, h, s) with a contiguous
// last axis, so the (B, S, H, D) projections of the model come in as
// transposed views without a copy and o, dq, dk, dv go out in the layout
// the caller allocated.  Mask, exactly the reference's: kj < Skv (the true
// length: nothing is padded), qi >= kj when causal, qi - kj < window when a
// window is given; a masked score is the finite sentinel -1e30 and its
// weight is 0.  A fully masked row gives o = 0 and lse = -1e30 (l == 0
// counts as 1).  Inputs are fp32 or bf16; every product and sum is fp32
// (no TF32, p is never rounded to bf16); outputs in the input dtype, lse
// and delta fp32.
//
// What bounds them: at the training shapes (S = 4096, D = 128, causal)
// every K/V tile loaded serves 64 query rows, so the arithmetic, not the
// bytes, sets the least time: 4·B·H·S²·D/2 FLOP forward and 2.5 times that
// backward.  This first version runs on the fp32 FMA units (67 TFLOP/s
// peak on an H100 SXM), not on the tensor cores.
//
// Design: 256 threads per block as a 16 x 16 grid; thread (ty, tx) owns
// query (or key) rows ty*4 .. ty*4+3 of a 64-row tile and the columns
// tx + 16*j of every tile product, so each thread keeps a 4 x 4 block of
// scores and a 4 x (D/16) block of an accumulator in registers.  Tiles sit
// in shared memory as fp32 with a pitch of D + 1 floats, so the 16 lanes
// that read 16 different rows of a K tile at one column hit 16 banks.
// Tiles that are wholly invisible (above the diagonal when causal, past the
// window) are skipped by the loop bounds, the reference's pl.when(visible).
// - forward: one block per (b, h, tile of 64 query rows); it walks the
//   visible K/V tiles of KV head h / rep with the online softmax (running
//   max m, sum l and accumulator in fp32).  Row max and sum are reduced
//   across the 16 lanes of a row with shuffles, in a fixed order.
// - dk/dv pass: one block per (b, kv head, tile of 64 keys); it loops over
//   the rep query heads of its group and their visible query tiles,
//   recomputes p = exp(s - lse) and accumulates dk and dv in registers.
// - dq pass: one block per (b, h, tile of 64 query rows) over the visible
//   key tiles.
// No atomics anywhere, and every sum runs in a fixed order, so a call gives
// the same bits every time: the remat recompute reproduces o and lse, and a
// resumed training run repeats the straight one.
//
// Later work: wgmma on bf16 tiles with TMA loads, a fused delta, and a
// persistent schedule for the causal imbalance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kPitchP = kTile + 1; // pitch of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;  // the finite mask sentinel

struct View {  // element strides of a (B, heads, S, D) tensor, D contiguous
  long long b, h, s;
};

struct Mask {
  int Sq, Skv, causal, has_window, window;
  __device__ __forceinline__ bool visible(int qi, int kj) const {
    bool ok = qi < Sq && kj < Skv;
    if (causal) ok = ok && qi >= kj;
    if (has_window) ok = ok && qi - kj < window;
    return ok;
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows row0 .. row0+63 of slice (b, h) into a 64 x (D+1) fp32 tile; rows at
// or past n_rows are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          View v, int b, int h, int row0,
                                          int n_rows) {
  const T* base = src + b * v.b + h * v.h;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < n_rows ? to_f(base[(long long)row * v.s + c]) : 0.f;
  }
}

// The 64-entry fp32 row vector `src[(b*H + h)*S + row0 ..]` into shared
// memory; rows at or past S are zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long offset, int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < S ? src[offset + row0 + r] : 0.f;
}

// s[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d] over two 64 x (D+1) tiles.
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float* a0 = A + ty * 4 * (D + 1);
  const float* b0 = B + tx * (D + 1);
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = b0[j * 16 * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// acc[i][j] += sum_t P[ty*4+i][t] * V[t][tx+16j]   (o += p·v, dq += ds·k)
template <int D>
__device__ __forceinline__ void acc_rows(float (&acc)[4][D / 16],
                                         const float* P, const float* V,
                                         int ty, int tx) {
  const float* p0 = P + ty * 4 * kPitchP;
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = p0[i * kPitchP + t];
    const float* vr = V + t * (D + 1) + tx;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float x = vr[j * 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_q P[q][ty*4+i] * X[q][tx+16j]   (dv += pᵀ·do, dk += dsᵀ·q)
template <int D>
__device__ __forceinline__ void acc_cols(float (&acc)[4][D / 16],
                                         const float* P, const float* X,
                                         int ty, int tx) {
#pragma unroll 4
  for (int q = 0; q < kTile; ++q) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[q * kPitchP + ty * 4 + i];
    const float* xr = X + q * (D + 1) + tx;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float x = xr[j * 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// Reductions over the 16 lanes (tx) that share a row; xor offsets below 16
// stay inside each half-warp, and the order is fixed.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Visible key range [k_lo, k_hi) of the query rows [q0, q0 + 64).
__device__ __forceinline__ void key_range(const Mask& mk, int q0, int* k_lo,
                                          int* k_hi) {
  const int q_last = min(q0 + kTile, mk.Sq) - 1;
  int hi = mk.Skv;
  if (mk.causal) hi = min(hi, q_last + 1);
  int lo = 0;
  if (mk.has_window) lo = max(0, q0 - mk.window + 1);
  *k_lo = lo;
  *k_hi = hi;
}

// ---------------------------------------------------------------------------
// Forward (kernels 8 and 9)
// ---------------------------------------------------------------------------

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, View vq, View vk, View vv,
                     View vo, int H, int KVH, Mask mk, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // 64 x (D+1)
  float* k_s = q_s + kTile * (D + 1); // 64 x (D+1)
  float* v_s = k_s + kTile * (D + 1); // 64 x (D+1)
  float* p_s = v_s + kTile * (D + 1); // 64 x 65
  // Heaviest tiles (the last query rows, when causal) first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  constexpr int NJ = D / 16;

  load_tile<T, D>(q_s, q, vq, b, h, q0, mk.Sq);
  int k_lo, k_hi;
  key_range(mk, q0, &k_lo, &k_hi);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, k, vk, b, g, k0, mk.Skv);
    load_tile<T, D>(v_s, v, vv, b, g, k0, mk.Skv);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mk.visible(qi, k0 + tx + 16 * j) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = row_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mk.visible(qi, k0 + tx + 16 * j)
                            ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * kPitchP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    acc_rows<D>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= mk.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + b * vo.b + h * vo.h + (long long)qi * vo.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / li);
    if (kLse && tx == 0)
      lse[((long long)b * H + h) * mk.Sq + qi] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 1: dk and dv (kernel 10, `_dkv_body`)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, View vq, View vk, View vv,
                         View vdo, View vdk, View vdv, int H, int KVH, Mask mk,
                         float scale) {
  extern __shared__ float smem[];
  float* k_s = smem;                     // 64 x (D+1)
  float* v_s = k_s + kTile * (D + 1);    // 64 x (D+1)
  float* q_s = v_s + kTile * (D + 1);    // 64 x (D+1)
  float* do_s = q_s + kTile * (D + 1);   // 64 x (D+1)
  float* p_s = do_s + kTile * (D + 1);   // 64 x 65
  float* ds_s = p_s + kTile * kPitchP;   // 64 x 65
  float* lse_s = ds_s + kTile * kPitchP; // 64
  float* dl_s = lse_s + kTile;           // 64
  const int kt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KVH;
  const int k0 = kt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  constexpr int NJ = D / 16;

  load_tile<T, D>(k_s, k, vk, b, g, k0, mk.Skv);
  load_tile<T, D>(v_s, v, vv, b, g, k0, mk.Skv);
  // Query rows that see a key of this tile: [q_lo, q_hi).
  const int k_last = min(k0 + kTile, mk.Skv) - 1;
  const int q_lo = mk.causal ? k0 : 0;
  int q_hi = mk.Sq;
  if (mk.has_window) q_hi = max(0, min(q_hi, k_last + mk.window));

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const long long row_off = ((long long)b * H + h) * mk.Sq;
    for (int q0 = (q_lo / kTile) * kTile; q0 < q_hi; q0 += kTile) {
      __syncthreads();
      load_tile<T, D>(q_s, q, vq, b, h, q0, mk.Sq);
      load_tile<T, D>(do_s, dout, vdo, b, h, q0, mk.Sq);
      load_rows(lse_s, lse, row_off, q0, mk.Sq);
      load_rows(dl_s, delta, row_off, q0, mk.Sq);
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<D>(s, q_s, k_s, ty, tx);
      dot_tile<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const float p = mk.visible(q0 + row, k0 + col)
                              ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
          p_s[row * kPitchP + col] = p;
          ds_s[row * kPitchP + col] = p * (dp[i][j] - dl_s[row]) * scale;
        }
      }
      __syncthreads();
      acc_cols<D>(dv_acc, p_s, do_s, ty, tx);
      acc_cols<D>(dk_acc, ds_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= mk.Skv) continue;
    T* dkr = dk + b * vdk.b + g * vdk.h + (long long)kj * vdk.s;
    T* dvr = dv + b * vdv.b + g * vdv.h + (long long)kj * vdv.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkr[tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dvr[tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 2: dq (kernel 10, `_dq_body`)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        View vq, View vk, View vv, View vdo, View vdq, int H,
                        int KVH, Mask mk, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // 64 x (D+1)
  float* do_s = q_s + kTile * (D + 1);   // 64 x (D+1)
  float* k_s = do_s + kTile * (D + 1);   // 64 x (D+1)
  float* v_s = k_s + kTile * (D + 1);    // 64 x (D+1)
  float* ds_s = v_s + kTile * (D + 1);   // 64 x 65
  float* lse_s = ds_s + kTile * kPitchP; // 64
  float* dl_s = lse_s + kTile;           // 64
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  constexpr int NJ = D / 16;
  const long long row_off = ((long long)b * H + h) * mk.Sq;

  load_tile<T, D>(q_s, q, vq, b, h, q0, mk.Sq);
  load_tile<T, D>(do_s, dout, vdo, b, h, q0, mk.Sq);
  load_rows(lse_s, lse, row_off, q0, mk.Sq);
  load_rows(dl_s, delta, row_off, q0, mk.Sq);
  int k_lo, k_hi;
  key_range(mk, q0, &k_lo, &k_hi);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(k_s, k, vk, b, g, k0, mk.Skv);
    load_tile<T, D>(v_s, v, vv, b, g, k0, mk.Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, q_s, k_s, ty, tx);
    dot_tile<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = mk.visible(q0 + row, k0 + col)
                            ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
        ds_s[row * kPitchP + col] = p * (dp[i][j] - dl_s[row]) * scale;
      }
    }
    __syncthreads();
    acc_rows<D>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= mk.Sq) continue;
    T* dqr = dq + b * vdq.b + h * vdq.h + (long long)qi * vdq.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqr[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

constexpr size_t tile_bytes(int D) { return sizeof(float) * kTile * (D + 1); }
constexpr size_t score_bytes() { return sizeof(float) * kTile * kPitchP; }

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

template <typename T, int D, bool kLse>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const long long* st, int B, int H, int KVH, Mask mk, float scale,
        cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes(D) + score_bytes();
  auto kernel = flash_fwd_kernel<T, D, kLse>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid((mk.Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, view(st),
      view(st + 3), view(st + 6), view(st + 9), H, KVH, mk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dk, void* dv,
        const long long* st, int B, int H, int KVH, Mask mk, float scale,
        cudaStream_t stream) {
  const size_t smem =
      4 * tile_bytes(D) + 2 * score_bytes() + 2 * sizeof(float) * kTile;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid((mk.Skv + kTile - 1) / kTile, KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), view(st), view(st + 3),
      view(st + 6), view(st + 9), view(st + 12), view(st + 15), H, KVH, mk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dqp, const long long* st,
       int B, int H, int KVH, Mask mk, float scale, cudaStream_t stream) {
  const size_t smem =
      4 * tile_bytes(D) + score_bytes() + 2 * sizeof(float) * kTile;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid((mk.Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqp), view(st), view(st + 3), view(st + 6),
      view(st + 9), view(st + 12), H, KVH, mk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLse>
int fwd_entry(const void* q, const void* k, const void* v, void* o, void* lse,
              const long long* strides, int B, int H, int KVH, int Sq,
              int Skv, int D, int causal, int has_window, int window,
              float scale, int bf16, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const Mask mk{Sq, Skv, causal, has_window, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16) {
    if (D == 64)
      return fwd<__nv_bfloat16, 64, kLse>(q, k, v, o, l, strides, B, H, KVH,
                                          mk, scale, s);
    return fwd<__nv_bfloat16, 128, kLse>(q, k, v, o, l, strides, B, H, KVH,
                                         mk, scale, s);
  }
  if (D == 64)
    return fwd<float, 64, kLse>(q, k, v, o, l, strides, B, H, KVH, mk, scale,
                                s);
  return fwd<float, 128, kLse>(q, k, v, o, l, strides, B, H, KVH, mk, scale,
                               s);
}

}  // namespace

// Argument conventions shared by the entries below.  Pointers to the (B,
// heads, S, D) tensors; `strides` holds the (b, h, s) element strides of
// each tensor in argument order (the last axis of every one is
// contiguous); D is 64 or 128 (the wrapper raises on any other);
// has_window = 0 ignores `window`; bf16 != 0 means every tensor but lse
// and delta is bf16, else fp32.  Each returns cudaGetLastError() after its
// launch.

// Kernel 8: o only.  strides: q, k, v, o.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int H,
                                     int KVH, int Sq, int Skv, int D,
                                     int causal, int has_window, int window,
                                     float scale, int bf16, void* stream) {
  return fwd_entry<false>(q, k, v, o, nullptr, strides, B, H, KVH, Sq, Skv, D,
                          causal, has_window, window, scale, bf16, stream);
}

// Kernel 9: o and lse (B, H, Sq) fp32, contiguous.  strides: q, k, v, o.
extern "C" int repro_flash_attention_lse(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         const long long* strides, int B,
                                         int H, int KVH, int Sq, int Skv,
                                         int D, int causal, int has_window,
                                         int window, float scale, int bf16,
                                         void* stream) {
  return fwd_entry<true>(q, k, v, o, lse, strides, B, H, KVH, Sq, Skv, D,
                         causal, has_window, window, scale, bf16, stream);
}

// Kernel 10, pass 1: dk, dv.  lse and delta (B, H, Sq) fp32, contiguous.
// strides: q, k, v, do, dk, dv.
extern "C" int repro_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int KVH, int Sq, int Skv, int D,
    int causal, int has_window, int window, float scale, int bf16,
    void* stream) {
  if (B == 0 || KVH == 0 || Skv == 0)
    return static_cast<int>(cudaGetLastError());
  const Mask mk{Sq, Skv, causal, has_window, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16) {
    if (D == 64)
      return dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dk, dv, strides, B,
                                    H, KVH, mk, scale, s);
    return dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dk, dv, strides, B,
                                   H, KVH, mk, scale, s);
  }
  if (D == 64)
    return dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, strides, B, H, KVH,
                          mk, scale, s);
  return dkv<float, 128>(q, k, v, dout, l, dl, dk, dv, strides, B, H, KVH, mk,
                         scale, s);
}

// Kernel 10, pass 2: dq.  strides: q, k, v, do, dq.
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dqp, const long long* strides,
    int B, int H, int KVH, int Sq, int Skv, int D, int causal, int has_window,
    int window, float scale, int bf16, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const Mask mk{Sq, Skv, causal, has_window, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16) {
    if (D == 64)
      return dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dqp, strides, B, H,
                                   KVH, mk, scale, s);
    return dq<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dqp, strides, B, H,
                                  KVH, mk, scale, s);
  }
  if (D == 64)
    return dq<float, 64>(q, k, v, dout, l, dl, dqp, strides, B, H, KVH, mk,
                         scale, s);
  return dq<float, 128>(q, k, v, dout, l, dl, dqp, strides, B, H, KVH, mk,
                        scale, s);
}
