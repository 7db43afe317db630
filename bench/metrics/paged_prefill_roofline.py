"""Share of its roofline that the paged prefill attention reaches in the
profiled slice: the least time for the work of the slice's prefill calls
(``harness.flops.prefill_attention``: each row's causal chunk against its
context; the larger of bytes over HBM bandwidth and operations over the
float32 peak) over the device time of the kernels below that the prefill
calls launched."""
from harness import flops
from harness.trace import span_kernel_seconds

#: Profiler names of the paged prefill kernels (``paged_split.cuh``).
KERNELS = ("split_kernel", "combine_kernel")


def read(record):
    summary, pk = record.get("trace"), record.get("peaks")
    calls = [(c["counts"], c["starts"])
             for c in record.get("prefill_calls", []) if c["traced"]]
    if not summary or not pk or not calls:
        return None
    secs, _ = span_kernel_seconds(summary, "prefill", KERNELS)
    if secs <= 0:
        return None
    ops, byt = flops.prefill_attention(record["shape"],
                                       record["kv_elem_bytes"], calls)
    bound = max(byt / pk["hbm_bytes_per_s"], ops / pk["fp32_flops"])
    return 100.0 * bound / secs
