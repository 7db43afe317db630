"""Share of its roofline that the flash attention kernels reach in the
profiled training steps: the least time for the work of their launches
(each forward-with-lse launch two causal products of ``seq²/2 · head_dim``
per head, each backward five, over the microbatch; operations over the
bf16 tensor-core peak, since the attention's bytes are far below it) over
the device time of the kernels below, in percent."""
from harness import flops
from harness.trace import kernel_seconds

#: Profiler names of the flash kernels on the bf16 route (``namespace tc``
#: of ``flash_attention.cu``): the forward with lse, the backward's dk/dv
#: and dq passes, and the backward's row sums.
FORWARD = ("fwd_kernel",)
BACKWARD = ("dkv_kernel", "dq_kernel", "delta_kernel")
#: The kernel a backward launches exactly once.
BACKWARD_ONCE = ("dkv_kernel",)


def read(record):
    summary, pk = record.get("trace"), record.get("peaks")
    if not summary or not pk:
        return None
    f_s, n_fwd = kernel_seconds(summary, FORWARD)
    b_s, _ = kernel_seconds(summary, BACKWARD)
    _, n_bwd = kernel_seconds(summary, BACKWARD_ONCE)
    if f_s + b_s <= 0:
        return None
    one = flops.causal_attention_flops(record["config"],
                                       record["micro_batch"], record["seq"],
                                       1.0) / record["config"][
                                           "num_hidden_layers"]
    ops = one * (2 * n_fwd + 5 * n_bwd)
    return 100.0 * (ops / pk["bf16_flops"]) / (f_s + b_s)
