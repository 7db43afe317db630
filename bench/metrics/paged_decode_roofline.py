"""Share of its roofline that the paged decode attention reaches in the
profiled slice: the least time the card could take for the work of the
slice's decode calls (the larger of bytes over HBM bandwidth and
operations over the float32 peak, ``harness.flops.decode_attention``),
over the device time of the kernels below that the decode calls launched.
"""
from harness import flops
from harness.trace import span_kernel_seconds

#: Profiler names of the paged decode kernels: the span blocks and the
#: combine of ``paged_split.cuh``.
KERNELS = ("split_kernel", "combine_kernel")


def read(record):
    summary, pk = record.get("trace"), record.get("peaks")
    calls = [(c["n"], c["lens"]) for c in record.get("decode_calls", [])
             if c["traced"]]
    if not summary or not pk or not calls:
        return None
    secs, _ = span_kernel_seconds(summary, "decode", KERNELS)
    if secs <= 0:
        return None
    ops, byt = flops.decode_attention(record["shape"],
                                      record["kv_elem_bytes"], calls)
    bound = max(byt / pk["hbm_bytes_per_s"], ops / pk["fp32_flops"])
    return 100.0 * bound / secs
