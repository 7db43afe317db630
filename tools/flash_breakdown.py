"""Flash kernels 8-10 on the card: per-pass times and tolerance shares.

Times, at the training path's shapes (bf16, B = 2, 32/4 heads, S = 4096,
D = 128, causal, (B, S, H, D) views), the forward with lse (kernel 9), the
forward alone (kernel 8) and the backward (kernel 10) with CUDA events,
splits the backward into its kernels (delta, dk/dv pass, dq pass) with
``torch.profiler``, times SDPA's forward beside them, and prints each bf16
output's largest share of ``chip_smoke.py``'s tolerance (fp32 tolerance
plus 2 bf16 steps) on the same cases as ``chip_smoke.check_flash_kernels``.
A quicker look than the whole ``chip_smoke.py``.  Needs a GPU; run from
the root of a checkout::

    PYTHONPATH=src:. python tools/flash_breakdown.py
"""
from __future__ import annotations

import statistics
import subprocess

import torch
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import ops

CASES = [  # tag, flash_inputs shape, causal, window
    ("path", dict(b=2, h=32, kvh=4, sq=4096), True, None),
    ("causal 1024", dict(sq=1024), True, None),
    ("window 256", dict(sq=1024), True, 256),
    ("ragged 1000 non-causal", dict(sq=1000), False, None),
    ("Sq 512 Skv 256 window 64", dict(sq=512, skv=256), True, 64),
    ("D 64", dict(sq=1024, d=64), True, None),
]


def event_ms(fn, n: int = 10) -> float:
    """Median of ``n`` CUDA-event times of ``fn`` after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def shares(inputs, causal, window):
    """Each output's largest share of chip_smoke's tolerance."""
    q, k, v, do = inputs
    kw = dict(causal=causal, window=window)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    po, plse = ops.flash_attention_fwd(q, k, v, impl="ref", **kw)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    pgrads = ops.flash_attention_bwd(q, k, v, o, lse, do, impl="ref", **kw)
    out = {}
    pairs = [("o", o, po, cs.FP32_FWD_TOL), ("lse", lse, plse, cs.FP32_FWD_TOL)]
    pairs += [(n, g, p, cs.FP32_BWD_TOL)
              for n, g, p in zip(("dq", "dk", "dv"), grads, pgrads)]
    for name, got, want, tol in pairs:
        allowed = tol["atol"] + tol["rtol"] * want.float().abs()
        if got.dtype == torch.bfloat16:
            allowed = allowed + cs.BF16_ULPS * cs.bf16_ulp(want)
        diff = (got.float() - want.float()).abs()
        out[name] = round((diff / allowed).max().item(), 4)
    return out


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, do = cs.flash_inputs("cuda", gen, 2, 32, 4, 4096, 128,
                                  torch.bfloat16)
    o, lse = ops.flash_attention_fwd(q, k, v)
    print("kernel 9 (fwd + lse) ms", event_ms(
        lambda: ops.flash_attention_fwd(q, k, v)))
    print("kernel 8 (fwd) ms", event_ms(lambda: ops.flash_attention(q, k, v)))
    print("kernel 10 (bwd) ms", event_ms(
        lambda: ops.flash_attention_bwd(q, k, v, o, lse, do)))
    print("SDPA fwd ms", event_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.flash_attention_fwd(q, k, v)
            ops.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us > 0:
            print(f"  {ev.key[:60]:60s} {us / ev.count / 1e3:.4f} ms "
                  f"x{ev.count}")
    del q, k, v, do, o, lse
    for tag, shape, causal, window in CASES:
        args = dict(b=1, h=8, kvh=1, d=128, dtype=torch.bfloat16)
        args.update(shape)
        inputs = cs.flash_inputs("cuda", gen, **args)
        print(tag, "shares", shares(inputs, causal, window))


if __name__ == "__main__":
    main()
