// Paged decode attention for Hopper: one query token per sequence against
// the page pool, the page walk split across blocks (flash-decoding).
//
// Replaces the Pallas TPU kernel `paged_decode_attention_kernel` (body
// `_paged_body`) of src/repro/kernels/paged_decode.py, and runs once per
// layer per decode step.
//
// What it computes: q (B, H, D) fp32; k/v pools (P, page, KVH, D), fp32,
// bf16 or int8 codes with (P, page, KVH) fp32 scales; page_table (B,
// n_pages) int32;
// lengths (B,) int32.  Head h attends with kv head h / (H / KVH) over the
// sequence's first lengths[b] tokens (clamped to the table); fp32 softmax;
// length 0 gives exact zeros.
//
// What bounds it: bytes.  Each live K/V token is read once per kv head
// (2 * D * elem bytes plus its scales) and feeds 2 * rep * D multiply-adds,
// rep = H / KVH = 8 at yi-6b, so about 1 to 2 flops per byte, far below
// the card's ratio: the floor is the live cache's bytes over the memory
// rate, and the way there is enough blocks with loads in flight.
//
// Design: the split-KV body of paged_split.cuh with one query position a
// row at lengths[b] - 1.  Block (span, kv head, sequence) walks one span of
// DECODE_SPAN positions (plans.py; 2 pages at page 16) for the rep query
// heads of its group, and a combine launch adds the spans in order.  At
// yi-6b with B = 8 and the serving lengths that is ~200 blocks with work,
// where one block per (sequence, kv head) gave 32 for 132 SMs.  A
// sequence's bits depend only on its own q, pages and length.

#include "paged_split.cuh"

// elem_bytes: 4, k/v are fp32; 2, bf16; 1, int8 codes with ks/vs the
// fp32 scale pools (ignored otherwise).  scratch holds the plan's
// partials; plan is the int array of plans.ATTENTION_FIELDS.
extern "C" int repro_paged_decode(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* table, const void* lengths,
                                  void* out, void* scratch, int B, int H,
                                  int KVH, int D, int page, int n_pages,
                                  float scale, int elem_bytes,
                                  const int* plan, void* stream) {
  paged_split::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = elem_bytes == 1 ? static_cast<const float*>(ks) : nullptr;
  a.vs = elem_bytes == 1 ? static_cast<const float*>(vs) : nullptr;
  a.table = static_cast<const int*>(table);
  a.starts = static_cast<const int*>(lengths);
  a.counts = nullptr;
  a.out = static_cast<float*>(out);
  a.R = B;
  a.C = 1;
  a.H = H;
  a.KVH = KVH;
  a.D = D;
  a.page = page;
  a.table_pages = n_pages;
  a.scale = scale;
  const size_t acc = (size_t)B * H * plan[1] * D;  // plan[1]: spans
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = a.part_acc + acc;
  return paged_split::run(a, plan, elem_bytes, stream);
}
