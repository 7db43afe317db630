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
// counts as 1).  Every sum is fp32; outputs in the input dtype, lse and
// delta = rowsum(do·o) fp32.  No atomics anywhere, and every sum runs in a
// fixed order, so a call gives the same bits every time: the remat
// recompute reproduces o and lse, and a resumed training run repeats the
// straight one.
//
// What bounds them: at the training shapes (S = 4096, D = 128, causal)
// every K/V tile loaded serves 128 query rows, so the arithmetic, not the
// bytes, sets the least time: 4·B·H·S²·D/2 FLOP forward and 2.5 times that
// backward, at the bf16 tensor-core rate (989 TFLOP/s on an H100 SXM).
//
// Two routes, chosen by dtype alone; neither falls back to the other.
//
// bf16 (the training path): tensor cores, namespace `tc`.  Blocks of three
// warpgroups: warpgroups 0-1 compute, each owning 64 rows (queries, or keys
// in the dk/dv pass); one thread of warpgroup 2 streams tiles by TMA
// through a 4-stage ring of mbarrier-signalled buffers (setmaxnreg moves
// registers from it to the two consumers).  Tiles stay bf16 in shared
// memory with the 128-byte swizzle, a D = 128 row as two 64-column boxes;
// the tensor maps are 4-D over (D, and s, h, b ordered by stride), and TMA
// zero-fills rows past Sq/Skv, which the mask then drops.  Products are
// wgmma m64nNk16 (bf16 in, fp32 accumulate): q·kᵀ and do·vᵀ from shared
// memory as they are (a bf16 x bf16 product is exact in fp32); for the
// products whose left operand the kernel computes (p·v, pᵀ·do, dsᵀ·q,
// ds·k), p and ds are split into hi = bf16(x) and lo = bf16(x - hi) and
// both halves accumulate into one fp32 sum, which keeps the fp32
// contract's tolerances (a single bf16 rounding of p breaks them 30- to
// 55-fold).  The tensor cores' fp32 accumulation rounds less well than
// fp32 FMAs over long chains, so no chain runs long: the forward takes each
// tile's p·v into a fresh accumulator and adds it into o in registers, and
// the dk/dv pass moves its sums into fp32 partials every 64 tiles.  The
// online softmax runs on the accumulator fragment, a row's max and sum
// reduced over the 4 threads that hold it by shuffles in a fixed order;
// the scores and p·v of the next tile overlap (forward and dq pass).
// - forward (kernels 8 and 9, one template): a block per 128 query rows,
//   heaviest causal tiles first, over K/V tiles of 64 keys.
// - dk/dv pass: a block per 128 keys, key tile 0 (the heaviest when causal)
//   first, over Q/dO tiles of 64 rows of each of the group's rep query
//   heads in a fixed order; the GQA sum stays in the block (registers and
//   the block's own fp32 partials), so no atomics are needed.
// - dq pass: a block per 128 query rows over K/V tiles of 64 keys.
// Tiles wholly invisible to a warpgroup are skipped (the reference's
// pl.when(visible)); the ring still passes them.
// Head dims 64 and 128 fill one and two boxes.  D = 80 (hubert-xlarge's
// 1280 / 16) runs the D = 128 layout: a row is 160 bytes, wider than one
// 128-byte swizzle span, so the tensor maps cover the true 80 columns and
// the second box of each row, columns 64..127, is filled by TMA's
// out-of-bounds zeros.  q·kᵀ and do·vᵀ take the 5 k-steps of the true D;
// p·v, pᵀ·do, dsᵀ·q and ds·k run at N = 128 (the zero columns add exact
// zeros, and the stores drop them), so those products do 128/80 of the
// work they need.  The softmax scale is the caller's (1/√80).
//
// fp32: the first version's SIMT kernels, unchanged (D = 80 is 5 columns a
// thread where D = 64 is 4).  A single-pass
// tensor-core product cannot meet the fp32 tolerance of 2e-5, and nothing
// on the training path is fp32.  256 threads per block as a 16 x 16 grid;
// thread (ty, tx) owns rows ty*4 .. ty*4+3 of a 64-row tile and the
// columns tx + 16*j of every tile product; tiles sit in shared memory as
// fp32 with a pitch of D + 1 floats; products are fp32 FMAs.
// - forward: one block per (b, h, tile of 64 query rows) over the visible
//   K/V tiles with the online softmax.
// - dk/dv pass: one block per (b, kv head, tile of 64 keys) over the rep
//   query heads and their visible query tiles.
// - dq pass: one block per (b, h, tile of 64 query rows).
//
// delta is a small kernel of its own, launched by the dk/dv entry before
// that pass: one warp per row, in a fixed order, from do and o as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
// delta = rowsum(do·o) (kernel 10's residual)
// ---------------------------------------------------------------------------

// One warp per (b, h, row) of delta (B, H, Sq): lane l sums columns l,
// l + 32, ... in order, then a shuffle tree in a fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                 float* __restrict__ delta, View vdo, View vo, int H, int Sq,
                 int D, long long rows) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const T* d = dout + b * vdo.b + h * vdo.h + (long long)i * vdo.s;
  const T* x = o + b * vo.b + h * vo.h + (long long)i * vo.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(d[c]), to_f(x[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16 inputs): kernels 8, 9 and 10 on wgmma + TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kConsumers = 2;                     // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int kRows = 64 * kConsumers;            // a block's own rows
constexpr int kStep = 64;                         // rows of a streamed tile
constexpr int kStages = 4;                        // ring depth
constexpr int kBox = kStep * 128;                 // bytes: 64 rows x 64 cols
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// The dk/dv pass moves its tensor-core sums into fp32 partials every
// kPromote Q/dO tiles (see dkv_kernel).
constexpr int kPromote = 64;
constexpr float kLog2e = 1.4426950408889634f;

// The width a D-column row takes in the tiles: whole 64-column boxes.
__host__ __device__ constexpr int width(int D) {
  return (D + 63) / 64 * 64;
}

// e^x as the SFU's 2^x (flushing results below 2^-126 to zero).
__device__ __forceinline__ float exp_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// A consumer warp is done with a stage: one arrival per warp, after all
// its lanes are (the barrier counts 4 * kConsumers).
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Does any (query, key) pair of rows [r_lo, r_hi) x keys [c_lo, c_hi) pass
// the mask?  Exact for a rectangle: the differences qi - kj fill one
// interval.
__device__ __forceinline__ bool any_visible(const Mask& mk, int r_lo,
                                            int r_hi, int c_lo, int c_hi) {
  r_hi = min(r_hi, mk.Sq);
  c_hi = min(c_hi, mk.Skv);
  if (r_lo >= r_hi || c_lo >= c_hi) return false;
  if (mk.causal && c_lo > r_hi - 1) return false;
  if (mk.has_window && r_lo - (c_hi - 1) >= mk.window) return false;
  return true;
}

// Does every pair pass?  Then the per-element mask can be skipped.
__device__ __forceinline__ bool all_visible(const Mask& mk, int r_lo, int r_hi,
                                            int c_lo, int c_hi) {
  return r_hi <= mk.Sq && c_hi <= mk.Skv && (!mk.causal || c_hi - 1 <= r_lo) &&
         (!mk.has_window || (r_hi - 1) - c_lo < mk.window);
}

// Key tiles of kStep that rows [q0, q0 + kRows) visit: first tile, count.
__device__ __forceinline__ void key_tiles(const Mask& mk, int q0, int* first,
                                          int* count) {
  const int q_last = min(q0 + kRows, mk.Sq) - 1;
  int hi = mk.Skv;
  if (mk.causal) hi = min(hi, q_last + 1);
  const int lo = mk.has_window ? max(0, q0 - mk.window + 1) : 0;
  *first = lo / kStep;
  *count = hi > lo ? (hi - *first * kStep + kStep - 1) / kStep : 0;
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  wgmma_rs_n64(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  wgmma_rs_n128(d, a, b, accumulate);
}

// s = A·Bᵀ over D: A = 64 rows of a K-major tile of `a_rows` rows (from row
// a_row0), B = a 64-row K-major tile.  Not committed.
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* a,
                                       int a_rows, int a_row0,
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    wgmma_ss_n64(s,
                 desc_sw128(a + box * a_rows * 128 + a_row0 * 128 + off, 16,
                            1024),
                 desc_sw128(b + box * kBox + off, 16, 1024), kk > 0);
  }
}

// acc (+)= (hi + lo)·X, the 64 x 64 left operand split into two bf16
// register fragments, X a 64-row tile read MN-major; `fresh` overwrites
// acc instead of adding to it.  Not committed.
template <int N>
__device__ __forceinline__ void acc_split(float (&acc)[N], const uint32_t* hi,
                                          const uint32_t* lo, const uint8_t* x,
                                          bool fresh = false) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, hi + 4 * kk, desc_sw128(x + kk * 16 * 128, kBox, 1024),
             !(fresh && kk == 0));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, lo + 4 * kk, desc_sw128(x + kk * 16 * 128, kBox, 1024), 1);
}

// The accumulator fragment of m64nNk16: register i of a thread holds row
// warp*16 + lane/4 + 8*((i>>1)&1), column 8*(i>>2) + 2*(lane%4) + (i&1).
__device__ __forceinline__ int frag_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n_full,
                                              int n_empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_full; ++i) mbar_init(&bars[i], 1);
    for (int i = 0; i < n_empty; ++i)
      mbar_init(&bars[n_full + i], 4 * kConsumers);
    fence_barrier_init();
  }
  __syncthreads();
}

// Rows [r0, r0+8) of an m64nN accumulator `acc` (two rows a thread), each
// times `mul[r]`, into bf16 rows of `out` (element row stride `rs`): the
// first kCols columns (the rest are a padded tile's zeros).
template <int kCols, int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* out, long long rs,
                                           int row, int n_rows, int lane,
                                           const float* mul) {
  static_assert(kCols % 8 == 0 && kCols <= 2 * N, "columns of the tile");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n_rows) continue;
    __nv_bfloat16* o = out + (long long)(row + 8 * r) * rs;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const int i = 4 * n + 2 * r;
      *reinterpret_cast<uint32_t*>(o + frag_col(i, lane)) =
          pack_bf16(acc[i] * mul[r], acc[i + 1] * mul[r]);
    }
  }
}

// [first, end) of the tiles it = 0 .. n - 1 (keys (kt0 + it) * kStep on)
// that rows [r_lo, r_lo + 64) see: one span, since each row sees one
// interval of keys and both its ends grow with the row.
__device__ __forceinline__ void visible_span(const Mask& mk, int r_lo, int kt0,
                                             int n, int* first, int* end) {
  int a = 0;
  while (a < n && !any_visible(mk, r_lo, r_lo + 64, (kt0 + a) * kStep,
                               (kt0 + a + 1) * kStep))
    ++a;
  int e = a;
  while (e < n && any_visible(mk, r_lo, r_lo + 64, (kt0 + e) * kStep,
                              (kt0 + e + 1) * kStep))
    ++e;
  *first = a;
  *end = e;
}

// Let tile `it` of a ring of two full barriers pass unused.
__device__ __forceinline__ void pass_tile(uint64_t* full_a, uint64_t* full_b,
                                          uint64_t* empty, int it) {
  const int st = it % kStages;
  const uint32_t par = (it / kStages) & 1;
  mbar_wait(&full_a[st], par);
  mbar_wait(&full_b[st], par);
  release(&empty[st]);
}

// Online softmax of a 64 x 64 score tile in the accumulator fragment (rows
// row0, row0 + 8 of this thread; keys from k0): masks and scales s, raises
// m to the new row maxima, turns s into p, and gives p's row sums and the
// factor alpha that rescales the sums before it.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&sum)[2], float (&alpha)[2],
                                             const Mask& mk, float scale,
                                             int row0, int k0, int lane,
                                             bool all) {
  float mx[2] = {m[0], m[1]};
  if (all) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= scale;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const bool vis = mk.visible(row0 + 8 * r, k0 + frag_col(i, lane));
      s[i] = vis ? s[i] * scale : kNegInf;
      mx[r] = fmaxf(mx[r], s[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    sum[r] = 0.f;
  }
  if (all) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp_(s[i] - mx[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const bool vis = mk.visible(row0 + 8 * r, k0 + frag_col(i, lane));
      s[i] = vis ? exp_(s[i] - mx[r]) : 0.f;
      sum[r] += s[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    alpha[r] = exp_(m[r] - mx[r]);
    m[r] = mx[r];
  }
}

// ds = p·(dp - delta)·scale of a 64 x 64 tile with rows = queries (row0,
// row0 + 8 of this thread), in place of dp.
__device__ __forceinline__ void ds_rows(const float (&s)[32], float (&dp)[32],
                                        const Mask& mk, float scale,
                                        const float (&lse)[2],
                                        const float (&delta)[2], int row0,
                                        int k0, int lane, bool all) {
  if (all) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      dp[i] = exp_(s[i] * scale - lse[r]) * (dp[i] - delta[r]) * scale;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const bool vis = mk.visible(row0 + 8 * r, k0 + frag_col(i, lane));
      const float pv = vis ? exp_(s[i] * scale - lse[r]) : 0.f;
      dp[i] = pv * (dp[i] - delta[r]) * scale;
    }
  }
}

// The dk/dv pass's sums run on the tensor cores' fp32 accumulation, whose
// rounding error grows with the length of the chain: over the 32,768
// query rows of a yi-6b GQA group at S = 4096 it passes the tolerance.  So
// every kPromote tiles each thread adds its dk, dv into fp32 partials of
// its own in device memory (round to nearest, a fixed order) and restarts
// the chain from zero.  `accumulate` = false starts the partials; `take`
// moves the partials back into dk, dv instead, at the end.
template <int N>
__device__ __forceinline__ void promote_one(float (&acc)[N], float4* part,
                                            int t, bool accumulate,
                                            bool take) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float4* slot = part + j * 128 + t;
    float4 v = accumulate ? *slot : make_float4(0.f, 0.f, 0.f, 0.f);
    v.x += acc[4 * j];
    v.y += acc[4 * j + 1];
    v.z += acc[4 * j + 2];
    v.w += acc[4 * j + 3];
    if (take) {
      acc[4 * j] = v.x;
      acc[4 * j + 1] = v.y;
      acc[4 * j + 2] = v.z;
      acc[4 * j + 3] = v.w;
    } else {
      *slot = v;
      acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.f;
    }
  }
}
template <int N>
__device__ __forceinline__ void promote(float (&dk)[N], float (&dv)[N],
                                        float4* part, int t, bool accumulate,
                                        bool take = false) {
  promote_one(dk, part, t, accumulate, take);
  promote_one(dv, part + (N / 4) * 128, t, accumulate, take);
}

struct FwdParams {
  TmaView q, k, v;
  __nv_bfloat16* o;
  float* lse;
  View vo;
  int B, H, KVH, n_qt;
  Mask mk;
  float scale;
};

// Kernels 8 (kLse = false) and 9: one block per (tile of 128 query rows,
// b, h), heaviest tiles first; warpgroups 0-1 each own 64 rows, warpgroup
// 2's first thread streams K/V tiles of 64 keys through the ring.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ FwdParams p) {
  constexpr int W = width(D);
  constexpr int NB = W / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);          // [NB][128 rows][128 B]
  uint8_t* k_s = q_s + NB * kRows * 128;       // [stage][NB][64][128 B]
  uint8_t* v_s = k_s + kStages * NB * kBox;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * NB * kBox);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int hb = p.H * p.B;
  const int qt = p.n_qt - 1 - blockIdx.x / hb;
  const int h = (blockIdx.x % hb) % p.H;
  const int b = (blockIdx.x % hb) / p.H;
  const int g = h / (p.H / p.KVH);
  const int q0 = qt * kRows;
  int kt0, n_kt;
  key_tiles(p.mk, q0, &kt0, &n_kt);
  init_barriers(bars, 1 + 2 * kStages, kStages);
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, NB * kRows * 128);
      for (int x = 0; x < NB; ++x)
        tma_load(q_s + x * kRows * 128, p.q, q_full, x * 64, q0, h, b);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        const int k0 = (kt0 + it) * kStep;
        mbar_expect_tx(&k_full[st], NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load(k_s + (st * NB + x) * kBox, p.k, &k_full[st], x * 64, k0,
                   g, b);
        mbar_expect_tx(&v_full[st], NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load(v_s + (st * NB + x) * kBox, p.v, &v_full[st], x * 64, k0,
                   g, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int r_lo = q0 + wg * 64;
    const int row0 = r_lo + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    float o[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    // Software pipeline over the span of tiles this warpgroup sees: tile
    // j's scores are taken while pv = p·v of tile j - 1 runs, and tile
    // j - 1's stage is released once that product is done.  Each tile's
    // p·v is a fresh tensor-core sum of 8 steps, added into o in fp32 with
    // round to nearest: one chain over all keys would carry the tensor
    // cores' rounding over 512 steps.
    float pv[W / 2];
    int first, end;
    visible_span(p.mk, r_lo, kt0, n_kt, &first, &end);
    for (int it = 0; it < first; ++it) pass_tile(k_full, v_full, empty, it);
    if (first < end) {
      uint32_t ph[16], pl[16];  // p of the pending tile, hi and lo halves
      int pst = first % kStages;  // its stage
      {
        const uint32_t par = (first / kStages) & 1;
        const int k0 = (kt0 + first) * kStep;
        mbar_wait(&k_full[pst], par);
        mbar_wait(&v_full[pst], par);
        float s[32], sum[2], alpha[2];
        wgmma_fence();
        scores<D>(s, q_s, kRows, wg * 64, k_s + pst * NB * kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        softmax_tile(s, m, sum, alpha, p.mk, p.scale, row0, k0, lane,
                     all_visible(p.mk, r_lo, r_lo + 64, k0, k0 + kStep));
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = sum[r];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          split_bf16(s[2 * j], s[2 * j + 1], &ph[j], &pl[j]);
      }
      for (int it = first + 1; it < end; ++it) {
        const int st = it % kStages;
        const uint32_t par = (it / kStages) & 1;
        const int k0 = (kt0 + it) * kStep;
        mbar_wait(&k_full[st], par);
        mbar_wait(&v_full[st], par);
        float s[32], sum[2], alpha[2];
        wgmma_fence();
        scores<D>(s, q_s, kRows, wg * 64, k_s + st * NB * kBox);
        wgmma_commit();
        acc_split(pv, ph, pl, v_s + pst * NB * kBox, /*fresh=*/true);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        softmax_tile(s, m, sum, alpha, p.mk, p.scale, row0, k0, lane,
                     all_visible(p.mk, r_lo, r_lo + 64, k0, k0 + kStep));
        wgmma_wait<0>();
        fence_regs(pv);
        release(&empty[pst]);
        // Only now may ph, pl take the new p: the product that read them
        // is done.
#pragma unroll
        for (int j = 0; j < 16; ++j)
          split_bf16(s[2 * j], s[2 * j + 1], &ph[j], &pl[j]);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
        for (int i = 0; i < W / 2; ++i)
          o[i] = (o[i] + pv[i]) * alpha[(i >> 1) & 1];
        pst = st;
      }
      wgmma_fence();
      acc_split(pv, ph, pl, v_s + pst * NB * kBox, /*fresh=*/true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      release(&empty[pst]);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) o[i] += pv[i];
    }
    for (int it = end; it < n_kt; ++it) pass_tile(k_full, v_full, empty, it);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float li = l[r] == 0.f ? 1.f : l[r];
      inv[r] = 1.f / li;
      if (kLse && (lane & 3) == 0 && row0 + 8 * r < p.mk.Sq)
        p.lse[((long long)b * p.H + h) * p.mk.Sq + row0 + 8 * r] =
            m[r] + logf(li);
    }
    store_rows<D>(o, p.o + b * p.vo.b + h * p.vo.h, p.vo.s, row0, p.mk.Sq,
                  lane, inv);
  }
}

struct BwdParams {
  TmaView q, k, v, dout;
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;  // dq pass
  __nv_bfloat16* dk;  // dk/dv pass
  __nv_bfloat16* dv;
  float4* partial;    // dk/dv pass: fp32 sums, kRows * width(D) * 2 floats
                      // a block
  View vdq, vdk, vdv;
  int B, H, KVH, n_tiles;
  Mask mk;
  float scale;
};

// Kernel 10, pass 1: one block per (tile of 128 keys, b, kv head), key
// tile 0 (the heaviest when causal) first.  Warpgroups 0-1 each own 64
// keys and keep dk, dv in registers; the producer streams Q/dO tiles of 64
// query rows over the rep heads of the group, in a fixed order.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ BwdParams p) {
  constexpr int W = width(D);
  constexpr int NB = W / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);          // [NB][128 rows][128 B]
  uint8_t* v_s = k_s + NB * kRows * 128;
  uint8_t* q_s = v_s + NB * kRows * 128;       // [stage][NB][64][128 B]
  uint8_t* do_s = q_s + kStages * NB * kBox;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * NB * kBox);
  float* dl_s = lse_s + kConsumers * kStep;    // [warpgroup][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + kConsumers * kStep);
  uint64_t* kv_full = bars;
  uint64_t* q_full = bars + 1;
  uint64_t* do_full = q_full + kStages;
  uint64_t* empty = do_full + kStages;

  const int gb = p.KVH * p.B;
  const int kt = blockIdx.x / gb;
  const int g = (blockIdx.x % gb) % p.KVH;
  const int b = (blockIdx.x % gb) / p.KVH;
  const int rep = p.H / p.KVH;
  const int k0 = kt * kRows;
  // Query rows that see a key of this block: [q_lo, q_hi), by tiles.
  const int k_last = min(k0 + kRows, p.mk.Skv) - 1;
  const int q_lo = p.mk.causal ? k0 : 0;
  int q_hi = p.mk.Sq;
  if (p.mk.has_window) q_hi = max(0, min(q_hi, k_last + p.mk.window));
  const int qt0 = q_lo / kStep;
  const int n_qt = q_hi > q_lo ? (q_hi - qt0 * kStep + kStep - 1) / kStep : 0;
  const int n_it = rep * n_qt;
  init_barriers(bars, 1 + 2 * kStages, kStages);
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(kv_full, 2 * NB * kRows * 128);
      for (int x = 0; x < NB; ++x) {
        tma_load(k_s + x * kRows * 128, p.k, kv_full, x * 64, k0, g, b);
        tma_load(v_s + x * kRows * 128, p.v, kv_full, x * 64, k0, g, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        const int h = g * rep + it / n_qt;
        const int q0 = (qt0 + it % n_qt) * kStep;
        mbar_expect_tx(&q_full[st], NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load(q_s + (st * NB + x) * kBox, p.q, &q_full[st], x * 64, q0,
                   h, b);
        mbar_expect_tx(&do_full[st], NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load(do_s + (st * NB + x) * kBox, p.dout, &do_full[st], x * 64,
                   q0, h, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int c_lo = k0 + wg * 64;                      // this group's keys
    const int key0 = c_lo + (t >> 5) * 16 + (lane >> 2);
    float* lse_w = lse_s + wg * kStep;
    float* dl_w = dl_s + wg * kStep;
    float dk[W / 2], dv[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    // This warpgroup's fp32 partials: W / 4 float4 a thread, thread-minor.
    float4* part = p.partial + (blockIdx.x * kConsumers + wg) * (W / 4) * 128;
    int chunks = 0;  // sums moved into `part` so far
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int h = g * rep + it / n_qt;
      const int q0 = (qt0 + it % n_qt) * kStep;
      if (any_visible(p.mk, q0, q0 + kStep, c_lo, c_lo + 64)) {
        // This tile's lse and delta, once per warpgroup.
        const long long row_off = ((long long)b * p.H + h) * p.mk.Sq + q0;
        named_sync(1 + wg, 128);  // the previous tile's readers are done
        const int qi = t & 63;
        const float* src = t < 64 ? p.lse : p.delta;
        (t < 64 ? lse_w : dl_w)[qi] =
            q0 + qi < p.mk.Sq ? src[row_off + qi] : 0.f;
        named_sync(1 + wg, 128);
        mbar_wait(&q_full[st], par);
        mbar_wait(&do_full[st], par);
        float s[32], dp[32];
        wgmma_fence();
        scores<D>(s, k_s, kRows, wg * 64, q_s + st * NB * kBox);
        scores<D>(dp, v_s, kRows, wg * 64, do_s + st * NB * kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // Rows are keys, columns queries: pᵀ and dsᵀ.
        const bool all = all_visible(p.mk, q0, q0 + kStep, c_lo, c_lo + 64);
        // p into s, ds into dp, in place.
        if (all) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = frag_col(i, lane);
            s[i] = exp_(s[i] * p.scale - lse_w[col]);
            dp[i] = s[i] * (dp[i] - dl_w[col]) * p.scale;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = frag_col(i, lane);
            const bool vis = p.mk.visible(q0 + col, key0 + frag_row(i));
            s[i] = vis ? exp_(s[i] * p.scale - lse_w[col]) : 0.f;
            dp[i] = s[i] * (dp[i] - dl_w[col]) * p.scale;
          }
        }
        uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          split_bf16(s[2 * j], s[2 * j + 1], &ph[j], &pl[j]);
          split_bf16(dp[2 * j], dp[2 * j + 1], &dh[j], &dl[j]);
        }
        wgmma_fence();
        acc_split(dv, ph, pl, do_s + st * NB * kBox);
        acc_split(dk, dh, dl, q_s + st * NB * kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      } else {
        mbar_wait(&q_full[st], par);
        mbar_wait(&do_full[st], par);
      }
      release(&empty[st]);
      if ((it + 1) % kPromote == 0 && it + 1 < n_it) {
        promote(dk, dv, part, t, chunks > 0);
        ++chunks;
      }
    }
    if (chunks > 0) promote(dk, dv, part, t, true, /*take=*/true);

    const float one[2] = {1.f, 1.f};
    store_rows<D>(dk, p.dk + b * p.vdk.b + g * p.vdk.h, p.vdk.s, key0,
                  p.mk.Skv, lane, one);
    store_rows<D>(dv, p.dv + b * p.vdv.b + g * p.vdv.h, p.vdv.s, key0,
                  p.mk.Skv, lane, one);
  }
}

// Kernel 10, pass 2: one block per (tile of 128 query rows, b, h),
// heaviest tiles first; warpgroups 0-1 each own 64 rows and keep dq in
// registers; the producer streams K/V tiles of 64 keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ BwdParams p) {
  constexpr int W = width(D);
  constexpr int NB = W / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);          // [NB][128 rows][128 B]
  uint8_t* do_s = q_s + NB * kRows * 128;
  uint8_t* k_s = do_s + NB * kRows * 128;      // [stage][NB][64][128 B]
  uint8_t* v_s = k_s + kStages * NB * kBox;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * NB * kBox);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int hb = p.H * p.B;
  const int qt = p.n_tiles - 1 - blockIdx.x / hb;
  const int h = (blockIdx.x % hb) % p.H;
  const int b = (blockIdx.x % hb) / p.H;
  const int g = h / (p.H / p.KVH);
  const int q0 = qt * kRows;
  int kt0, n_kt;
  key_tiles(p.mk, q0, &kt0, &n_kt);
  init_barriers(bars, 1 + 2 * kStages, kStages);
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, 2 * NB * kRows * 128);
      for (int x = 0; x < NB; ++x) {
        tma_load(q_s + x * kRows * 128, p.q, q_full, x * 64, q0, h, b);
        tma_load(do_s + x * kRows * 128, p.dout, q_full, x * 64, q0, h, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        const int k0 = (kt0 + it) * kStep;
        mbar_expect_tx(&k_full[st], NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load(k_s + (st * NB + x) * kBox, p.k, &k_full[st], x * 64, k0,
                   g, b);
        mbar_expect_tx(&v_full[st], NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load(v_s + (st * NB + x) * kBox, p.v, &v_full[st], x * 64, k0,
                   g, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int r_lo = q0 + wg * 64;
    const int row0 = r_lo + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const long long row_off = ((long long)b * p.H + h) * p.mk.Sq;
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row0 + 8 * r < p.mk.Sq;
      lse_r[r] = in ? p.lse[row_off + row0 + 8 * r] : 0.f;
      dl_r[r] = in ? p.delta[row_off + row0 + 8 * r] : 0.f;
    }
    float dq[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);

    // Software pipeline as in the forward: tile j's s and dp are taken
    // while dq += ds·k of tile j - 1 runs.
    int first, end;
    visible_span(p.mk, r_lo, kt0, n_kt, &first, &end);
    for (int it = 0; it < first; ++it) pass_tile(k_full, v_full, empty, it);
    if (first < end) {
      uint32_t dh[16], dl[16];  // ds of the pending tile, hi and lo halves
      int pst = first % kStages;  // its stage
      {
        const uint32_t par = (first / kStages) & 1;
        const int k0 = (kt0 + first) * kStep;
        mbar_wait(&k_full[pst], par);
        mbar_wait(&v_full[pst], par);
        float s[32], dp[32];
        wgmma_fence();
        scores<D>(s, q_s, kRows, wg * 64, k_s + pst * NB * kBox);
        scores<D>(dp, do_s, kRows, wg * 64, v_s + pst * NB * kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        ds_rows(s, dp, p.mk, p.scale, lse_r, dl_r, row0, k0, lane,
                all_visible(p.mk, r_lo, r_lo + 64, k0, k0 + kStep));
#pragma unroll
        for (int j = 0; j < 16; ++j)
          split_bf16(dp[2 * j], dp[2 * j + 1], &dh[j], &dl[j]);
      }
      for (int it = first + 1; it < end; ++it) {
        const int st = it % kStages;
        const uint32_t par = (it / kStages) & 1;
        const int k0 = (kt0 + it) * kStep;
        mbar_wait(&k_full[st], par);
        mbar_wait(&v_full[st], par);
        float s[32], dp[32];
        wgmma_fence();
        scores<D>(s, q_s, kRows, wg * 64, k_s + st * NB * kBox);
        scores<D>(dp, do_s, kRows, wg * 64, v_s + st * NB * kBox);
        wgmma_commit();
        acc_split(dq, dh, dl, k_s + pst * NB * kBox);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        ds_rows(s, dp, p.mk, p.scale, lse_r, dl_r, row0, k0, lane,
                all_visible(p.mk, r_lo, r_lo + 64, k0, k0 + kStep));
        wgmma_wait<0>();
        fence_regs(dq);
        release(&empty[pst]);
        // Only now may dh, dl take the new ds (see the forward).
#pragma unroll
        for (int j = 0; j < 16; ++j)
          split_bf16(dp[2 * j], dp[2 * j + 1], &dh[j], &dl[j]);
        pst = st;
      }
      wgmma_fence();
      acc_split(dq, dh, dl, k_s + pst * NB * kBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      release(&empty[pst]);
    }
    for (int it = end; it < n_kt; ++it) pass_tile(k_full, v_full, empty, it);

    const float one[2] = {1.f, 1.f};
    store_rows<D>(dq, p.dq + b * p.vdq.b + h * p.vdq.h, p.vdq.s, row0,
                  p.mk.Sq, lane, one);
  }
}

}  // namespace tc

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

namespace tc {

constexpr size_t kBarBytes = 8 * (1 + 3 * kStages);

// Shared memory of each kernel, with room to align the tiles to 1024.
constexpr size_t fwd_smem(int D) {
  return 1024 + (width(D) / 64) * (kRows * 128 + 2 * kStages * kBox) +
         kBarBytes;
}
constexpr size_t dq_smem(int D) {
  return 1024 + (width(D) / 64) * (2 * kRows * 128 + 2 * kStages * kBox) +
         kBarBytes;
}
constexpr size_t dkv_smem(int D) {
  return dq_smem(D) + 2 * sizeof(float) * kConsumers * kStep;
}

template <int D, bool kLse>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const long long* st, int B, int H, int KVH, Mask mk, float scale,
        cudaStream_t stream) {
  FwdParams p{};
  if (int err = make_view(&p.q, q, st, B, H, mk.Sq, D, kRows)) return err;
  if (int err = make_view(&p.k, k, st + 3, B, KVH, mk.Skv, D, kStep))
    return err;
  if (int err = make_view(&p.v, v, st + 6, B, KVH, mk.Skv, D, kStep))
    return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.vo = view(st + 9);
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.n_qt = (mk.Sq + kRows - 1) / kRows;
  p.mk = mk;
  p.scale = scale;
  auto kernel = fwd_kernel<D, kLse>;
  const size_t smem = fwd_smem(D);
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<p.n_qt * H * B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, do, dk, dv.
template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dk, void* dv,
        void* partial, const long long* st, int B, int H, int KVH, Mask mk,
        float scale, cudaStream_t stream) {
  BwdParams p{};
  if (int err = make_view(&p.q, q, st, B, H, mk.Sq, D, kStep)) return err;
  if (int err = make_view(&p.k, k, st + 3, B, KVH, mk.Skv, D, kRows))
    return err;
  if (int err = make_view(&p.v, v, st + 6, B, KVH, mk.Skv, D, kRows))
    return err;
  if (int err = make_view(&p.dout, dout, st + 9, B, H, mk.Sq, D, kStep))
    return err;
  p.lse = lse;
  p.delta = delta;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.partial = static_cast<float4*>(partial);
  p.vdk = view(st + 12);
  p.vdv = view(st + 15);
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.n_tiles = (mk.Skv + kRows - 1) / kRows;
  p.mk = mk;
  p.scale = scale;
  auto kernel = dkv_kernel<D>;
  const size_t smem = dkv_smem(D);
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<p.n_tiles * KVH * B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, do, dq.
template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dqp, const long long* st,
       int B, int H, int KVH, Mask mk, float scale, cudaStream_t stream) {
  BwdParams p{};
  if (int err = make_view(&p.q, q, st, B, H, mk.Sq, D, kRows)) return err;
  if (int err = make_view(&p.k, k, st + 3, B, KVH, mk.Skv, D, kStep))
    return err;
  if (int err = make_view(&p.v, v, st + 6, B, KVH, mk.Skv, D, kStep))
    return err;
  if (int err = make_view(&p.dout, dout, st + 9, B, H, mk.Sq, D, kRows))
    return err;
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dqp);
  p.vdq = view(st + 12);
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.n_tiles = (mk.Sq + kRows - 1) / kRows;
  p.mk = mk;
  p.scale = scale;
  auto kernel = dq_kernel<D>;
  const size_t smem = dq_smem(D);
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<p.n_tiles * H * B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// strides: do, o.
template <typename T>
int launch_delta(const void* dout, const void* o, float* dl,
                 const long long* st, int B, int H, int Sq, int D,
                 cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  constexpr int kRowsPerBlock = 8;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  delta_kernel<T><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o), dl, view(st),
      view(st + 3), H, Sq, D, rows);
  return static_cast<int>(cudaGetLastError());
}

// Runs `f` with the head dim as a compile-time constant: 64, 80 or 128
// (the wrapper raises on any other).
template <typename F>
int with_head_dim(int D, F f) {
  switch (D) {
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 80:
      return f(std::integral_constant<int, 80>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (bf16)
      return tc::fwd<kD, kLse>(q, k, v, o, l, strides, B, H, KVH, mk, scale,
                               s);
    return fwd<float, kD, kLse>(q, k, v, o, l, strides, B, H, KVH, mk, scale,
                                s);
  });
}

}  // namespace

// Argument conventions shared by the entries below.  Pointers to the (B,
// heads, S, D) tensors; `strides` holds the (b, h, s) element strides of
// each tensor in argument order (the last axis of every one is
// contiguous); D is 64, 80 or 128 (the wrapper raises on any other);
// has_window = 0 ignores `window`; bf16 != 0 means every tensor but lse
// and delta is bf16 (the tensor-core route: q, k, v and do 16-byte aligned
// with strides of a multiple of 8 elements, as TMA needs), else fp32 (the
// SIMT route).  Each returns 0 or the first CUDA error of its launches.

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

// Kernel 10, pass 1: delta = rowsum(do·o) into `delta`, then dk, dv.  lse
// and delta (B, H, Sq) fp32, contiguous.  `partial`: an fp32 buffer of
// B * KVH * ceil(Skv / 128) * 128 * W * 2 floats for the bf16 route, W =
// D rounded up to a multiple of 64 (the dk/dv sums of each block), unused
// by the fp32 one.  strides: q, k, v,
// do, o, dk, dv.
extern "C" int repro_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* lse, void* delta, void* dk, void* dv,
    void* partial, const long long* strides, int B, int H, int KVH, int Sq, int Skv, int D,
    int causal, int has_window, int window, float scale, int bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  if (B > 0 && H > 0 && Sq > 0) {
    const long long* st = strides + 9;  // do, o
    const int err =
        bf16 ? launch_delta<__nv_bfloat16>(dout, o, dl, st, B, H, Sq, D, s)
             : launch_delta<float>(dout, o, dl, st, B, H, Sq, D, s);
    if (err) return err;
  }
  if (B == 0 || KVH == 0 || Skv == 0)
    return static_cast<int>(cudaGetLastError());
  const Mask mk{Sq, Skv, causal, has_window, window};
  const float* l = static_cast<const float*>(lse);
  long long st[18];  // q, k, v, do, dk, dv
  for (int i = 0; i < 12; ++i) st[i] = strides[i];
  for (int i = 12; i < 18; ++i) st[i] = strides[i + 3];
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (bf16)
      return tc::dkv<kD>(q, k, v, dout, l, dl, dk, dv, partial, st, B, H, KVH,
                         mk, scale, s);
    return dkv<float, kD>(q, k, v, dout, l, dl, dk, dv, st, B, H, KVH, mk,
                          scale, s);
  });
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
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (bf16)
      return tc::dq<kD>(q, k, v, dout, l, dl, dqp, strides, B, H, KVH, mk,
                        scale, s);
    return dq<float, kD>(q, k, v, dout, l, dl, dqp, strides, B, H, KVH, mk,
                         scale, s);
  });
}
