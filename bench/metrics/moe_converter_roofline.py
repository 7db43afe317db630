"""Share of their roofline that the MoE converters (the indirect scatter
and gather under dispatch and combine) reach in the profiled training
steps: the bytes they need (each launch reads and writes the kept rows
once: kept assignments of the dispatch calls times the launches a call
makes, times 2 x the row's bytes) over HBM bandwidth, over their device
time, in percent."""
from harness.trace import kernel_seconds

#: Profiler names of the converter kernels (``stream_converters.cu``).
KERNELS = ("indirect_scatter_kernel", "indirect_gather_kernel")


def read(record):
    summary, pk = record.get("trace"), record.get("peaks")
    disp = record.get("dispatch") or {}
    calls, kept = disp.get("calls"), disp.get("kept")
    if not summary or not pk or not calls or not kept:
        return None
    secs, launches = kernel_seconds(summary, KERNELS)
    if secs <= 0:
        return None
    byt = kept * (launches / calls) * 2 * record["row_bytes"]
    return 100.0 * (byt / pk["hbm_bytes_per_s"]) / secs
