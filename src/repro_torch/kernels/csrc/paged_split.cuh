// Split-KV paged attention for Hopper: the block body and the combine that
// paged_decode.cu and paged_prefill.cu share.
//
// The problem, in the prefill form (decode is the same with one query
// position a row at length - 1): q (R, C, H, D) fp32, where row r's query
// c sits at position starts[r] + c; k/v pools (P, page, KVH, D): fp32,
// bf16, or int8 codes with (P, page, KVH) fp32 scales; a page table
// (R, pages).
// Query c of row r sees positions p < min(starts + c + 1, starts + counts,
// pages * page); the mask sentinel is the finite -1e30, and a query that
// sees nothing gives exact zeros.
//
// Design (the plan is kernels/plans.py's AttentionPlan; the C entries
// launch it as given):
//
// * Each row's context is cut into spans of a fixed number of positions,
//   a whole number of pages.  Block (s, tile * KVH + g, r) takes span s of
//   row r for kv head g and a tile of query rows: tq positions times the
//   rep = H / KVH query heads of the group, so each K/V row loaded serves
//   the whole group.  A block whose span starts at or past the last
//   position its tile sees returns before it loads anything.
// * The block walks its span in kv tiles of D / 4 positions through two
//   cp.async stages: the next tile's K and V rows (and int8 scales) are in
//   flight while the current one is computed.  Narrow rows (bf16, int8
//   codes) land in a raw stage and are widened to fp32 right after: bf16
//   exactly, int8 times its scale.  So every product below sees the same
//   fp32 values as on a pool of pool.float() (bf16) or of the dequantized
//   codes (int8), and a bf16 pool gives bitwise the output of its widened
//   fp32 copy.  Each token's row is looked up in the page table as it is
//   copied, so a page past the written context is never read.
// * Scores: each thread holds 2 query rows x 4 kv positions, q and K read
//   from shared memory as float4 along D.  The products of the fp32 inputs
//   are summed in fp64 (each product is exact there) and the sum rounded
//   once to fp32: the correctly rounded dot product, which the plain
//   version then scales in fp32 as the kernel does.  A chain of fp32 FMAs
//   in D order ran 1.5x faster for prefill but flipped a greedy token of
//   the int8 speculative run against the plain path (PERF.md, §6): with
//   int8 pools a rounding difference that moves one code cascades through
//   the layers.  The online
//   softmax runs in registers: the lanes of a row pair reduce max and sum
//   with xor shuffles, which give every lane the same bits.  Probabilities
//   go to shared memory transposed, and each thread then adds p * v for 4
//   query rows x 8 columns in kv position order, its accumulator in
//   registers.
// * Each query row's partial (max m, sum l, unnormalized accumulator) goes
//   to a scratch buffer that the wrapper sizes from the plan.  A second
//   launch, the combine, adds for each query the spans it sees in span
//   order: M = max m_s, then L += l_s * exp(m_s - M) and
//   O += acc_s * exp(m_s - M), out = O / L (L = 0: zeros).  A span that
//   starts before a query's visible end holds at least one position that
//   query sees, so every partial it adds has l >= 1.
//
// So the bits of a query depend on its own q, pages, start and count, and
// on the span and kv-tile constants; not on R or B, the table's width, the
// other rows or the tile it rides in.  The split is fixed by the span, not
// by a target number of blocks.
//
// What bounds it: decode and verify read each live K/V row once per kv
// head for a handful of queries, so bytes; a prefill chunk of 32 positions
// does 2 * 32 * rep * D flops per K/V row loaded, so the SIMT rate: the
// scores at the fp64 rate (half the fp32 one), p . v in fp32 FMAs.  No
// tensor cores and no TF32, to keep the kernels within 1e-5 of the plain
// versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: paged_decode.cu and paged_prefill.cu each build their
// own copy into their own library, and the two are loaded side by side.
namespace paged_split {
namespace {

constexpr float kNegInf = -1e30f;  // the finite mask sentinel
constexpr int kMaxThreads = 256;   // plans.ATTN_MAX_THREADS

// The launch fields of plans.AttentionPlan, in the order of
// plans.ATTENTION_FIELDS.
struct Plan {
  int span, spans, kv_tile, tq, tile_rows, q_tiles, threads, unit;
  int k_off, v_off, raw_off, pt_off, alpha_off, k_stage, v_stage, raw_stage;
  int smem_bytes, combine_blocks;
};

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* ks;      // int8 scale pools, else null
  const float* vs;
  const int* table;     // (R, table_pages)
  const int* starts;    // prefill: starts; decode: lengths
  const int* counts;    // prefill: counts; decode: null
  float* out;           // (R, C, H, D)
  float* part_acc;      // (R * C * H, spans, D)
  float* part_ml;       // (R * C * H, spans, 2)
  int R, C, H, KVH, D, page, table_pages;
  float scale;
  Plan p;
};

// (start, live) of row r: query c sees positions < min(start + c + 1,
// live, table positions).
__device__ __forceinline__ void row_bounds(const Args& a, int r, int& st,
                                           int& live) {
  if (a.counts == nullptr) {
    const int cap = a.table_pages * a.page;
    int n = a.starts[r];
    n = n < 0 ? 0 : (n > cap ? cap : n);
    st = n - 1;
    live = n;
  } else {
    st = a.starts[r];
    const int cnt = a.counts[r];
    live = cnt > 0 ? st + cnt : 0;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int unit) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (unit == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 at src (16-byte aligned) as 8 fp32 at dst (16-byte aligned),
// exactly.
__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]);
  const float2 f3 = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
}

// Start the copies of positions [base, base + n) of row r, kv head g, into
// one stage: fp32 rows straight into the K (padded) and V tiles; bf16 rows,
// int8 codes and int8 scales into the raw stage (K rows, then V rows, then
// the K and V scales).
template <typename T>
__device__ __forceinline__ void load_tile(const Args& a, int r, int g,
                                          int base, int n, float* k_dst,
                                          float* v_dst, unsigned char* raw) {
  const int D = a.D;
  const int unit = a.p.unit;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int units = row_bytes / unit;
  const int* trow = a.table + (size_t)r * a.table_pages;
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  constexpr bool kNarrow = sizeof(T) < 4;
  constexpr bool kScaled = sizeof(T) == 1;
  for (int e = threadIdx.x; e < n * units; e += blockDim.x) {
    const int t = e / units;
    const int u = e - t * units;
    const int pos = base + t;
    const size_t tok = (size_t)trow[pos / a.page] * a.page + pos % a.page;
    const size_t src = ((tok * a.KVH + g) * D) * sizeof(T) + (size_t)u * unit;
    if (kNarrow) {
      cp_async(raw + t * row_bytes + u * unit, kp + src, unit);
      cp_async(raw + (a.p.kv_tile + t) * row_bytes + u * unit, vp + src,
               unit);
    } else {
      cp_async(reinterpret_cast<char*>(k_dst + t * (D + 4)) + u * unit,
               kp + src, unit);
      cp_async(reinterpret_cast<char*>(v_dst + t * D) + u * unit, vp + src,
               unit);
    }
  }
  if (kScaled) {
    float* sc = reinterpret_cast<float*>(raw + 2 * a.p.kv_tile * D);
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int pos = base + t;
      const size_t tok = (size_t)trow[pos / a.page] * a.page + pos % a.page;
      cp_async(sc + t, a.ks + tok * a.KVH + g, 4);
      cp_async(sc + a.p.kv_tile + t, a.vs + tok * a.KVH + g, 4);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = a.p;
  const int s = blockIdx.x;
  const int tile = blockIdx.y / a.KVH;
  const int g = blockIdx.y - tile * a.KVH;
  const int r = blockIdx.z;
  const int D = a.D;
  const int KT = p.kv_tile;
  const int rep = a.H / a.KVH;
  const int cap = a.table_pages * a.page;
  constexpr bool kNarrow = sizeof(T) < 4;  // widened after the raw stage
  constexpr bool kScaled = sizeof(T) == 1;

  int st, live;
  row_bounds(a, r, st, live);
  const int c0 = tile * p.tq;
  const int nq = min(p.tq, a.C - c0);
  const int hi = min(min(st + c0 + nq, live), cap);
  const int lo = s * p.span;
  if (lo >= hi) return;  // masked for the whole tile: no page is loaded
  const int end = min(lo + p.span, hi);
  const int n_tiles = (end - lo + KT - 1) / KT;
  const int rows = nq * rep;  // tile row e = position (e / rep), head e % rep
  const int tid = threadIdx.x;

  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + p.k_off);
  float* v_s = reinterpret_cast<float*>(smem + p.v_off);
  unsigned char* raw = smem + p.raw_off;
  float* pt = reinterpret_cast<float*>(smem + p.pt_off);
  float* alpha_s = reinterpret_cast<float*>(smem + p.alpha_off);
  const int PS = p.tile_rows + 4;  // pt row stride
  const int KS = D + 4;            // K row stride: 8 rows hit 32 banks

  // q tile (rows past the tile's zeroed), in the first commit group.
  {
    const int units = D * 4 / p.unit;
    for (int e = tid; e < p.tile_rows * units; e += blockDim.x) {
      const int row = e / units;
      const int u = e - row * units;
      char* dst = reinterpret_cast<char*>(q_s + row * D) + u * p.unit;
      if (row < rows) {
        const int cq = row / rep;
        const size_t qrow =
            ((size_t)r * a.C + c0 + cq) * a.H + (size_t)g * rep + row % rep;
        cp_async(dst, reinterpret_cast<const char*>(a.q + qrow * D) +
                          u * p.unit, p.unit);
      } else {
        for (int b = 0; b < p.unit; b += 4)
          *reinterpret_cast<float*>(dst + b) = 0.f;
      }
    }
  }
  load_tile<T>(a, r, g, lo, min(KT, end - lo), k_s, v_s, raw);
  cp_async_commit();

  // Score mapping: rows R0, R0 + 1, kv positions cq + G * b.
  const int G = KT / 4;
  const int rq = tid / G;
  const int cq = tid - rq * G;
  const int R0 = 2 * rq;
  int vend[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = R0 + i;
    vend[i] = row < rows ? min(min(st + c0 + row / rep + 1, live), end) : 0;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // Accumulator mapping: rows 4 * rg + i, columns 4 * cg and 4 * cg + D / 2.
  const int NCG = D / 8;
  const int rg = tid / NCG;
  const int cg = tid - rg * NCG;
  float4 acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = 0; j < n_tiles; ++j) {
    const int base = lo + j * KT;
    const int n_valid = min(KT, end - base);
    const int stage = kNarrow ? 0 : (j & 1);
    if (j + 1 < n_tiles) {
      const int nxt = kNarrow ? 0 : ((j + 1) & 1);
      load_tile<T>(a, r, g, base + KT, min(KT, end - base - KT),
                   k_s + nxt * (p.k_stage / 4), v_s + nxt * (p.v_stage / 4),
                   raw + ((j + 1) & 1) * p.raw_stage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = k_s + stage * (p.k_stage / 4);
    const float* vt = v_s + stage * (p.v_stage / 4);
    if constexpr (kNarrow) {
      const unsigned char* rs = raw + (j & 1) * p.raw_stage;
      const T* kc = reinterpret_cast<const T*>(rs);
      const T* vc = kc + KT * D;
      float* kd = k_s;
      float* vd = v_s;
      if constexpr (kScaled) {
        const float* sc = reinterpret_cast<const float*>(rs + 2 * KT * D);
        for (int e = tid; e < n_valid * D; e += blockDim.x) {
          const int t = e / D;
          const int i = e - t * D;
          kd[t * KS + i] = static_cast<float>(kc[e]) * sc[t];
          vd[e] = static_cast<float>(vc[e]) * sc[KT + t];
        }
      } else {
        // bf16: 8 elements (16 bytes) a step, two float4 stores each.  A
        // decode block has 32 threads: one element a step left the decode
        // kernel 20% behind its time on fp32 pools (PERF.md, section 6).
        const int R8 = D / 8;
        for (int e = tid; e < n_valid * R8; e += blockDim.x) {
          const int t = e / R8;
          const int i = (e - t * R8) * 8;
          widen8(kc + t * D + i, kd + t * KS + i);
          widen8(vc + t * D + i, vd + t * D + i);
        }
      }
      __syncthreads();
    }

    // Scores of rows R0, R0 + 1 against positions cq + G * b: fp32
    // products summed in fp64, rounded once.
    const float* q0 = q_s + R0 * D;
    const float* q1 = q0 + D;
    const float* kr = kt + cq * KS;
    double sd[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) sd[i][b] = 0.0;
    for (int i = 0; i < D; i += 4) {
      const float4 x0 = ld4(q0 + i);
      const float4 x1 = ld4(q1 + i);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float4 y = ld4(kr + b * G * KS + i);
        sd[0][b] = fma((double)x0.x, (double)y.x, sd[0][b]);
        sd[0][b] = fma((double)x0.y, (double)y.y, sd[0][b]);
        sd[0][b] = fma((double)x0.z, (double)y.z, sd[0][b]);
        sd[0][b] = fma((double)x0.w, (double)y.w, sd[0][b]);
        sd[1][b] = fma((double)x1.x, (double)y.x, sd[1][b]);
        sd[1][b] = fma((double)x1.y, (double)y.y, sd[1][b]);
        sd[1][b] = fma((double)x1.z, (double)y.z, sd[1][b]);
        sd[1][b] = fma((double)x1.w, (double)y.w, sd[1][b]);
      }
    }
    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[i][b] = static_cast<float>(sd[i][b]);

    // Online softmax of the two rows over this tile.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        vis[b] = base + cq + G * b < vend[i];
        sc[i][b] *= a.scale;
        if (vis[b]) mx = fmaxf(mx, sc[i][b]);
      }
      for (int o = 1; o < G; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float e = vis[b] ? expf(sc[i][b] - mn) : 0.f;
        pt[(cq + G * b) * PS + R0 + i] = e;
        sum += e;
      }
      for (int o = 1; o < G; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float al = expf(m[i] - mn);
      l[i] = l[i] * al + sum;
      m[i] = mn;
      if (cq == 0) alpha_s[R0 + i] = al;
    }
    __syncthreads();

    // acc = acc * alpha + p . v, in kv position order.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha_s[4 * rg + i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[i][h].x *= al;
        acc[i][h].y *= al;
        acc[i][h].z *= al;
        acc[i][h].w *= al;
      }
    }
    const float* pr = pt + 4 * rg;
    const float* v0 = vt + 4 * cg;
    const float* v1 = v0 + D / 2;
    for (int t = 0; t < n_valid; ++t) {
      const float4 pp = ld4(pr + t * PS);
      const float4 y0 = ld4(v0 + t * D);
      const float4 y1 = ld4(v1 + t * D);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0].x = fmaf(pv[i], y0.x, acc[i][0].x);
        acc[i][0].y = fmaf(pv[i], y0.y, acc[i][0].y);
        acc[i][0].z = fmaf(pv[i], y0.z, acc[i][0].z);
        acc[i][0].w = fmaf(pv[i], y0.w, acc[i][0].w);
        acc[i][1].x = fmaf(pv[i], y1.x, acc[i][1].x);
        acc[i][1].y = fmaf(pv[i], y1.y, acc[i][1].y);
        acc[i][1].z = fmaf(pv[i], y1.z, acc[i][1].z);
        acc[i][1].w = fmaf(pv[i], y1.w, acc[i][1].w);
      }
    }
    __syncthreads();
  }

  // Partials of the tile's query rows for span s.
  const size_t S = p.spans;
  if (cq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = R0 + i;
      if (row < rows) {
        const size_t qi = ((size_t)r * a.C + c0 + row / rep) * a.H +
                          (size_t)g * rep + row % rep;
        a.part_ml[(qi * S + s) * 2] = m[i];
        a.part_ml[(qi * S + s) * 2 + 1] = l[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * rg + i;
    if (row < rows) {
      const size_t qi = ((size_t)r * a.C + c0 + row / rep) * a.H +
                        (size_t)g * rep + row % rep;
      float* dst = a.part_acc + (qi * S + s) * D + 4 * cg;
      *reinterpret_cast<float4*>(dst) = acc[i][0];
      *reinterpret_cast<float4*>(dst + D / 2) = acc[i][1];
    }
  }
}

// One thread per (query, 4 columns): the spans the query sees, in order.
__global__ void combine_kernel(const Args a) {
  const int D4 = a.D / 4;
  const size_t total = (size_t)a.R * a.C * a.H * D4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t qi = idx / D4;
  const int u = static_cast<int>(idx - qi * D4);
  const int c = static_cast<int>((qi / a.H) % a.C);
  const int r = static_cast<int>(qi / ((size_t)a.H * a.C));
  int st, live;
  row_bounds(a, r, st, live);
  const int cap = a.table_pages * a.page;
  const int ve = min(min(st + c + 1, live), cap);
  const int n_s = ve > 0 ? (ve + a.p.span - 1) / a.p.span : 0;
  const size_t S = a.p.spans;
  const float* ml = a.part_ml + qi * S * 2;
  const float* ac = a.part_acc + qi * S * a.D + 4 * u;
  float M = kNegInf;
  for (int s = 0; s < n_s; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_s; ++s) {
    const float w = expf(ml[2 * s] - M);
    L = fmaf(ml[2 * s + 1], w, L);
    const float4 x = ld4(ac + (size_t)s * a.D);
    o.x = fmaf(x.x, w, o.x);
    o.y = fmaf(x.y, w, o.y);
    o.z = fmaf(x.z, w, o.z);
    o.w = fmaf(x.w, w, o.w);
  }
  const float den = L == 0.f ? 1.f : L;
  *reinterpret_cast<float4*>(a.out + qi * a.D + 4 * u) =
      make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
}

// Launch the plan: the span blocks, then the combine, on one stream.
template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const Plan& p = a.p;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.spans, p.q_tiles * a.KVH, a.R);
  split_kernel<T><<<grid, p.threads, p.smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<p.combine_blocks, 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// elem_bytes: 4 fp32 pools, 2 bf16 pools, 1 int8 codes with scales.
inline int run(Args a, const int* plan, int elem_bytes, void* stream) {
  a.p = *reinterpret_cast<const Plan*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.R == 0 || a.C == 0) return static_cast<int>(cudaGetLastError());
  switch (elem_bytes) {
    case 4: return launch<float>(a, s);
    case 2: return launch<__nv_bfloat16>(a, s);
    case 1: return launch<int8_t>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace paged_split
