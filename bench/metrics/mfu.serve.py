"""Share of the card's float32 peak that the window's served work is:
model operations of the family calls of the window (the projections of
each token, attention over each token's context, and a row of logits per
decode token and per prefill row's last token) over the window's seconds
times the float32 peak (the served model computes in float32 with TF32
off), in percent.  The profiled slice, its calls and its reduction are
left out of both."""
import numpy as np

from harness import flops


def read(record):
    pk = record.get("peaks")
    if not pk:
        return None
    shape = record["shape"]
    tok = flops.serve_token_flops(shape)
    head = flops.serve_head_flops(shape)
    dec = [(c["n"], c["lens"]) for c in record["decode_calls"]
           if not c["traced"]]
    pre = [(c["counts"], c["starts"]) for c in record["prefill_calls"]
           if not c["traced"]]
    if not dec and not pre:
        return None
    n_dec = sum(n * len(lens) for n, lens in dec)
    n_pre = sum(int(np.asarray(c).sum()) for c, _ in pre)
    rows = sum(int((np.asarray(c) > 0).sum()) for c, _ in pre)
    ops = (tok * (n_dec + n_pre) + head * (n_dec + rows)
           + flops.decode_attention(shape, 0, dec)[0]
           + flops.prefill_attention(shape, 0, pre)[0])
    trace = record.get("trace")
    window = record["window_s"] - (trace["cost_s"] if trace else 0.0)
    return 100.0 * ops / (window * pk["fp32_flops"])
