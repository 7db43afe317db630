"""Each per-layer metric's reader gives the value worked out by hand on a
fixed record, and nothing where it finds nothing to read.

    PYTHONPATH=src python -m pytest bench/tests -q
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import flops  # noqa: E402
from harness.common import percentile  # noqa: E402
from harness.trace import reduce_events  # noqa: E402

PEAKS = {"hbm_bytes_per_s": 1e12, "fp32_flops": 1e13, "bf16_flops": 1e14}
SHAPE = {"layers": 2, "d": 8, "heads": 4, "kv_heads": 2, "head_dim": 2,
         "vocab": 10}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def summary(by_span=None, kernels=None, busy=1.0, window=4.0):
    return {"by_span": by_span or {}, "kernels": kernels or {},
            "busy_s": busy, "window_s": window, "idle_gaps": []}


def serve_record(trace=None):
    dec = [dict(t0=0.0, t1=0.03, n=3, lens=np.array([4, 6]), traced=False),
           dict(t0=1.0, t1=1.01, n=1, lens=np.array([10]), traced=True)]
    pre = [dict(t0=0.0, t1=0.5, counts=np.array([16, 4, 0, 0]),
                starts=np.array([0, 16, 0, 0]), traced=False),
           dict(t0=2.0, t1=2.2, counts=np.array([8, 0]),
                starts=np.array([32, 0]), traced=True)]
    return {"shape": SHAPE, "kv_elem_bytes": 2, "peaks": PEAKS,
            "window_s": 2.0, "decode_calls": dec, "prefill_calls": pre,
            "decode_n_active": [2, 2, 2, 1], "trace": trace}


def test_decode_batch_mean():
    assert reader("decode_batch_mean")(serve_record()) == 7 / 4
    assert reader("decode_batch_mean")({"decode_n_active": []}) is None


def test_decode_step_ms_leaves_out_traced_calls():
    assert reader("decode_step_ms")(serve_record()) == pytest.approx(10.0)


def test_prefill_ms_per_ktok():
    assert reader("prefill_ms_per_ktok")(serve_record()) == \
        pytest.approx(1e3 * 0.5 / (20 / 1e3))


def test_decode_attention_counts_by_hand():
    # one call of 1 step at length 10: 11 positions of context.
    ops, byt = flops.decode_attention(SHAPE, 2, [(1, np.array([10]))])
    assert ops == 4 * 4 * 2 * 2 * 11
    assert byt == 2 * 2 * 2 * 2 * 2 * 11 + 2 * 4 * 4 * 2 * 2
    # 3 steps of two slots at 4 and 6: (5+6+7) + (7+8+9) positions.
    ops, _ = flops.decode_attention(SHAPE, 2, [(3, np.array([4, 6]))])
    assert ops == 4 * 4 * 2 * 2 * 42


def test_paged_decode_roofline():
    tr = summary(by_span={"decode": {"split_kernel<bf16>": [2e-6, 2],
                                     "combine_kernel": [1e-6, 2],
                                     "sgemm": [5e-6, 9]},
                          "prefill": {"split_kernel<bf16>": [9.0, 1]}})
    ops, byt = flops.decode_attention(SHAPE, 2, [(1, np.array([10]))])
    bound = max(byt / 1e12, ops / 1e13)
    got = reader("paged_decode_roofline")(serve_record(tr))
    assert got == pytest.approx(100 * bound / 3e-6)
    assert reader("paged_decode_roofline")(serve_record(None)) is None


def test_paged_prefill_roofline():
    tr = summary(by_span={"prefill": {"split_kernel<bf16>": [1e-5, 2],
                                      "combine_kernel": [1e-5, 2]}})
    # one row of 8 tokens from position 32: 8·32 + 36 pairs, 40 positions.
    ops, byt = flops.prefill_attention(SHAPE, 2, [(np.array([8, 0]),
                                                   np.array([32, 0]))])
    assert ops == 4 * 4 * 2 * 2 * (8 * 32 + 36)
    assert byt == 2 * 2 * 2 * 2 * 2 * 40 + 2 * 4 * 4 * 2 * 2 * 8
    got = reader("paged_prefill_roofline")(serve_record(tr))
    assert got == pytest.approx(100 * max(byt / 1e12, ops / 1e13) / 2e-5)


def test_idle_shares():
    rec = {"trace": summary(busy=1.0, window=4.0)}
    assert reader("idle_share.serve")(rec) == pytest.approx(75.0)
    assert reader("idle_share.train")(rec) == pytest.approx(75.0)
    assert reader("idle_share.serve")({"trace": None}) is None


def test_mfu_serve_leaves_out_the_profiled_slice():
    rec = serve_record(dict(summary(), cost_s=0.5))
    tok = flops.serve_token_flops(SHAPE)
    head = flops.serve_head_flops(SHAPE)
    n_dec = 3 * 2
    n_pre = 20
    rows = 2
    att = (flops.decode_attention(SHAPE, 0, [(3, [4, 6])])[0]
           + flops.prefill_attention(SHAPE, 0, [([16, 4, 0, 0],
                                                 [0, 16, 0, 0])])[0])
    want = 100 * (tok * (n_dec + n_pre) + head * (n_dec + rows) + att) \
        / ((2.0 - 0.5) * 1e13)
    assert reader("mfu.serve")(rec) == pytest.approx(want)


MOE = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
       "num_key_value_heads": 2, "num_experts": 4, "num_experts_per_tok": 2,
       "intermediate_size": 3, "vocab_size": 10}


def train_record(trace):
    return {"config": MOE, "peaks": PEAKS, "micro_batch": 2, "seq": 16,
            "tokens_per_step": 64, "steps": 5, "window_s": 10.0,
            "trace": trace, "dispatch": {"calls": 8, "given": 256, "kept": 100},
            "dispatch_window": {"calls": 20, "given": 640, "kept": 480},
            "row_bytes": 16}


def test_flash_roofline():
    tr = summary(kernels={"tc::fwd_kernel": [1e-6, 4],
                          "tc::dkv_kernel": [2e-6, 2],
                          "tc::dq_kernel": [1e-6, 2], "gemm": [1.0, 9]})
    one = 2 * 2 * 2 * (16 * 16 / 2) * 4          # one causal product
    want = 100 * (one * (2 * 4 + 5 * 2) / 1e14) / 4e-6
    assert reader("flash_roofline")(train_record(tr)) == pytest.approx(want)


def test_moe_converter_roofline():
    tr = summary(kernels={"indirect_scatter_kernel": [1e-6, 12],
                          "indirect_gather_kernel": [1e-6, 12]})
    want = 100 * (100 * (24 / 8) * 2 * 16 / 1e12) / 2e-6
    got = reader("moe_converter_roofline")(train_record(tr))
    assert got == pytest.approx(want)


def test_mfu_train_counts_kept_assignments_only():
    dense = 2 * (8 * 4 * 8 + 8 * 4) + 8 * 10
    expert = 2 * 3 * 8 * 3
    kept = 64 * 2 * 480 / 640                     # 3/4 of top-2 kept
    attn = 6 * 2 * 4 * 2 * (16 * 16 / 2) * 4 * 2
    step = 6 * (dense * 64 + expert * kept) + attn
    want = 100 * step * 5 / (10.0 * 1e14)
    assert reader("mfu.train")(train_record(None)) == pytest.approx(want)
    rec = dict(train_record(dict(summary(), cost_s=2.0)), traced_steps=2)
    want = 100 * step * 3 / (8.0 * 1e14)
    assert reader("mfu.train")(rec) == pytest.approx(want)
    assert reader("mfu.train")(dict(rec, dispatch_window=None)) is None


def test_percentile_is_linear_between_order_statistics():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile(list(range(101)), 95) == 95
    assert percentile([0, 10], 95) == pytest.approx(9.5)


class _Ev:
    def __init__(self, name, a, b, device, corr=0):
        self.name = name
        self.id = corr
        self.time_range = type("R", (), {"start": a, "end": b})()
        self.device_type = type("D", (), {"name": device})()
        self.is_user_annotation = False


def test_reduce_events_attributes_kernels_to_spans_and_labels_gaps():
    events = [
        _Ev("bench.step", 0, 100, "CPU"),
        _Ev("bench.decode", 10, 40, "CPU"),
        _Ev("aten::mm", 12, 14, "CPU"),
        _Ev("cudaLaunchKernel", 13, 14, "CPU", corr=7),
        _Ev("cudaLaunchKernel", 15, 16, "CPU", corr=8),
        _Ev("bench.prefill", 50, 90, "CPU"),
        _Ev("cudaLaunchKernel", 51, 52, "CPU", corr=9),
        _Ev("sgemm", 20, 25, "CUDA", corr=7),
        _Ev("split_kernel", 25, 29, "CUDA", corr=8),
        _Ev("split_kernel", 60, 67, "CUDA", corr=9),
        _Ev("memset", 95, 96, "CUDA", corr=99),
    ]
    s = reduce_events(events, 1e-4)
    assert s["by_span"]["decode"] == {"sgemm": [5e-6, 1],
                                      "split_kernel": [4e-6, 1]}
    assert s["by_span"]["prefill"] == {"split_kernel": [7e-6, 1]}
    assert s["by_span"]["unlinked"] == {"memset": [1e-6, 1]}
    assert s["busy_s"] == pytest.approx(17e-6)
    assert s["idle_gaps"][0] == (pytest.approx(31e-6), "step")
    assert s["kernels"]["split_kernel"] == [pytest.approx(11e-6), 2]
