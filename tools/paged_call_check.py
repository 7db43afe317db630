"""Every paged attention call of the int8 serving runs, held three ways.

Run from the root of a checkout, on one NVIDIA GPU::

    PYTHONPATH=src:. python tools/paged_call_check.py

Serves ``chip_smoke.py``'s int8 runs (full-width yi-6b, the tight pool
that forces evictions; plain scheduler, then ``spec_k = 4``) with the
three paged attention wrappers hooked: each kernel call is repeated on
the plain version and on a float64 plain version of the same inputs.
Prints one JSON line per wrapper: calls, calls with an element outside
rtol = atol = 1e-5 of the plain version, the largest such difference, and
the mean absolute error of kernel and plain version against float64.
With random weights the scores reach thousands, so a score's fp32
rounding alone moves an output by more than 1e-5 of it; the comparison
with float64 says which side is closer.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch


def main() -> int:
    sys.path[:0] = ["src", "."]
    import chip_smoke as cs
    from repro_torch import serve as serve_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    if not torch.cuda.is_available():
        print("paged_call_check: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = get_config("yi-6b")
    prompts = cs.make_prompts(cfg.vocab)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = serve_mod.PagedLM(cfg, generator=gen, kv_dtype="fp32",
                               device=dev).params
    plain64 = {"paged_decode_attention": ref.paged_decode_attention,
               "paged_prefill_attention": ref.paged_prefill_attention,
               "paged_verify": ref.paged_verify_attention}
    stats = {}

    def hook(name):
        fn = getattr(ops, name)

        def wrap(*args, impl="cuda", k_scale=None, v_scale=None, **kw):
            got = fn(*args, impl=impl, k_scale=k_scale, v_scale=v_scale,
                     **kw)
            if impl != "cuda":
                return got
            want = fn(*args, impl="ref", k_scale=k_scale, v_scale=v_scale,
                      **kw)
            q, kp, vp, *rest = args
            if k_scale is not None:
                kp = ref.dequantize_pages(kp, k_scale)
                vp = ref.dequantize_pages(vp, v_scale)
            exact = plain64[name](q.double(), kp.double(), vp.double(),
                                  *rest, **kw)
            s = stats.setdefault(name, dict(calls=0, outside_1e5=0,
                                            max_diff=0.0, kernel_err=0.0,
                                            plain_err=0.0))
            s["calls"] += 1
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                s["outside_1e5"] += 1
                s["max_diff"] = max(s["max_diff"],
                                    float((got - want).abs().max()))
            s["kernel_err"] += float((got.double() - exact).abs().mean())
            s["plain_err"] += float((want.double() - exact).abs().mean())
            return got

        wrap.launches = 0
        wrap.plan = None
        return wrap

    for name in plain64:
        setattr(ops, name, hook(name))
    pool = cs.tight_pool(prompts)
    cs.serve(serve_mod, cfg, dev, params, "int8", prompts, pool)
    cs.serve_spec(serve_mod, cfg, dev, params, "int8", prompts, pool)
    for name, s in stats.items():
        s["kernel_err"] /= s["calls"]
        s["plain_err"] /= s["calls"]
        print(json.dumps(dict(card=smi, kernel=name, **s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
