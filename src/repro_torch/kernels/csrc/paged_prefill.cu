// Paged prefill attention for Hopper: causal chunk attention straight from
// the page pool, the page walk split across blocks.
//
// Replaces the Pallas TPU kernel `paged_prefill_attention_kernel` (body
// `_prefill_body`) of src/repro/kernels/paged_prefill.py, and runs once per
// layer per prefill chunk; `paged_verify_attention_kernel` of
// src/repro/kernels/paged_verify.py is the same launch with starts =
// lengths (ops.paged_verify), once per layer per verify step.
//
// What it computes: q (R, C, H, D) fp32, where row r's query c sits at
// position starts[r] + c; k/v pools (P, page, KVH, D), fp32, bf16 or int8
// codes with (P, page, KVH) fp32 scales; ctx_rows (R, ctx_pages) int32 leading
// page-table entries; starts, counts (R,) int32.  Query c sees kv positions
// p with p <= starts + c and p < starts + counts (and within ctx_pages
// pages); the mask uses the finite sentinel -1e30, and rows with counts ==
// 0 give exact zeros.
//
// What bounds it: at the serving shapes (chunk 32, rep 8) each context
// token read from the pool feeds 2 * C * rep * D multiply-adds per kv head,
// so a prefill chunk is bound by operations, on the fp32 FMA units (67
// TFLOP/s), not by bytes; a verify step (C = 4) is closer to its bytes.
//
// Design: the split-KV body of paged_split.cuh.  Block (span, tile x kv
// head, row) takes a tile of up to 64 query rows (8 positions x the 8
// heads of a group at yi-6b) against one span of PREFILL_SPAN positions
// (plans.py; 4 pages at page 16) in double-buffered kv tiles of 32, so
// each span's pages are read once per tile and the spans of a row run in
// parallel, where one block per tile walked the whole context serially.
// A combine launch adds each query's spans in order.  A query's bits
// depend only on its own row's q, pages, start and count.

#include "paged_split.cuh"

// elem_bytes: 4, k/v are fp32; 2, bf16; 1, int8 codes with ks/vs the
// fp32 scale pools (ignored otherwise).  scratch holds the plan's
// partials; plan is the int array of plans.ATTENTION_FIELDS.
extern "C" int repro_paged_prefill(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* ctx_rows, const void* starts,
                                   const void* counts, void* out,
                                   void* scratch, int R, int C, int H,
                                   int KVH, int D, int page, int ctx_pages,
                                   float scale, int elem_bytes,
                                   const int* plan, void* stream) {
  paged_split::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = elem_bytes == 1 ? static_cast<const float*>(ks) : nullptr;
  a.vs = elem_bytes == 1 ? static_cast<const float*>(vs) : nullptr;
  a.table = static_cast<const int*>(ctx_rows);
  a.starts = static_cast<const int*>(starts);
  a.counts = static_cast<const int*>(counts);
  a.out = static_cast<float*>(out);
  a.R = R;
  a.C = C;
  a.H = H;
  a.KVH = KVH;
  a.D = D;
  a.page = page;
  a.table_pages = ctx_pages;
  a.scale = scale;
  const size_t acc = (size_t)R * C * H * plan[1] * D;  // plan[1]: spans
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = a.part_acc + acc;
  return paged_split::run(a, plan, elem_bytes, stream);
}
