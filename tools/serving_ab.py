"""Paged attention kernels and serving throughput of one checkout, on the card.

Run from the root of a checkout, on one NVIDIA GPU::

    PYTHONPATH=src:. python tools/serving_ab.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``src/repro_torch`` is imported
(default: this one), so two versions can be compared in one call on one
card, in turns (parent, change, change, parent), each in its own process;
the shapes, the timing and the runs come from this checkout's
``chip_smoke.py``.  It prints one JSON line: the card's name and power
limit; the paged decode, prefill and verify kernels at ``chip_smoke.py``'s
shapes (fp32, int8 and bf16 pools: event and profiler device time a call,
median of 25); the isolated prefill and decode throughput of
``chip_smoke.py``'s throughput phase (full-width yi-6b, batch 8) on fp32
and on bf16 pools, with the step's wall and device time and the
profiler's kernel count of one decode step and one prefill chunk; and the
``spec_k = 4`` fp32 scheduler run's tokens/s.  ``--kv-dtypes`` narrows
the pools (e.g. ``fp32,int8`` for a checkout that has no bf16 pools).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--kv-dtypes", default="fp32,int8,bf16")
    args = ap.parse_args()
    kv_dtypes = args.kv_dtypes.split(",")
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import serve as serve_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda")
    cfg = get_config("yi-6b")
    prompts = cs.make_prompts(cfg.vocab)
    lens = [len(p) + cs.MAX_NEW // 2 for p in prompts]
    rng = np.random.default_rng(cs.SEED)
    kernels = {}
    for tag in [t for t in cs.POOL_TAGS if t in kv_dtypes]:
        h, kvh, d, kp, vp, ks, vs, table, lengths = cs.kernel_inputs(
            rng, dev, tag, lens)
        sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
        q = torch.randn(cs.BATCH, h, d, device=dev)
        qp = torch.randn(cs.BATCH, cs.CHUNK, h, d, device=dev)
        st = torch.tensor([0, 32, 64, 96, 128, 160, 256, 288],
                          dtype=torch.int32, device=dev)
        ct = torch.tensor([32, 32, 17, 32, 5, 32, 32, 0], dtype=torch.int32,
                          device=dev)
        qv = torch.randn(cs.BATCH, cs.SPEC_K, h, d, device=dev)
        vc = torch.tensor([cs.SPEC_K] * (cs.BATCH - 2) + [2, 0],
                          dtype=torch.int32, device=dev)
        rows = table[:, :32].contiguous()
        calls = {
            "decode": lambda: ops.paged_decode_attention(
                q, kp, vp, table, lengths, **sc),
            "prefill": lambda: ops.paged_prefill_attention(
                qp, kp, vp, rows, st, ct, **sc),
            "verify": lambda: ops.paged_verify(
                qv, kp, vp, rows, lengths, vc, **sc),
        }
        for name, fn in calls.items():
            kernels[f"{name} {tag}"] = dict(ms=cs.time_ms(fn),
                                            device_ms=cs.profile_ms(fn))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = serve_mod.PagedLM(cfg, generator=gen, kv_dtype="fp32",
                               device=dev).params
    keys = ("prefill_tokens_per_s", "decode_tokens_per_s",
            "decode_step_device_ms", "decode_step_wall_ms",
            "decode_step_kernels", "decode_step_busy_ms",
            "prefill_chunk_kernels", "prefill_chunk_busy_ms",
            "launches_per_decode_step", "launches_per_prefill_step")
    serving = {}
    for kv_dtype in [t for t in ("fp32", "bf16") if t in kv_dtypes]:
        tp = cs.throughput(serve_mod, cfg, dev, params, prompts, kv_dtype)
        serving[kv_dtype] = {k: tp[k] for k in keys}
    out, sched, counts, secs = cs.serve_spec(serve_mod, cfg, dev, params,
                                             "fp32", prompts)
    print(json.dumps(dict(
        label=args.label or str(root), card=smi, kernels=kernels,
        **serving["fp32"], bf16=serving.get("bf16"),
        spec_fp32_tokens_per_s=sched.stats.tokens / secs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
