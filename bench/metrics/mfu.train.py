"""Model FLOP utilisation of the training window: (6 x the parameters the
tokens passed through + causal attention's forward and backward
products, recompute not counted) of the steps completed, over the
window's seconds times the bf16 tensor-core peak, in percent.  The
parameters: attention, the router and the head for every token, and an
expert's three matrices for every assignment its dispatch kept (an
assignment dropped at capacity passes through no expert).  The kept share
is counted over the window's dispatch calls.  The profiled steps and the
slice's reduction are left out of both."""
from harness import flops


def read(record):
    pk, disp = record.get("peaks"), record.get("dispatch_window")
    if not pk or not record.get("steps") or not disp or not disp["given"]:
        return None
    cfg = record["config"]
    tokens = record["tokens_per_step"]
    assignments = tokens * cfg["num_experts_per_tok"] * disp["kept"] \
        / disp["given"]
    per_step = (6.0 * (flops.moe_dense_params(cfg) * tokens
                       + flops.moe_expert_params(cfg) * assignments)
                + flops.causal_attention_flops(cfg, tokens // record["seq"],
                                               record["seq"], 6.0))
    trace = record.get("trace")
    steps = record["steps"] - record.get("traced_steps", 0)
    window = record["window_s"] - (trace["cost_s"] if trace else 0.0)
    return 100.0 * per_step * steps / (window * pk["bf16_flops"])
