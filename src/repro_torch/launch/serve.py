"""Dense generation launcher of the port (from ``repro.launch.serve``).

:func:`dense_generate` is the whole-cache greedy loop over the full
``models.lm`` stack: one prefill of the prompts into a contiguous KV
cache, then one decode step per token.  It is how the reference serves a
Mixture-of-Experts model (olmoe-1b-7b), whose dispatch and combine run on
the indirect scatter and gather kernels; the paged and recurrent serving
engines live in :mod:`repro_torch.serve`.

Usage::

    python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke \
        --batch 4 --prompt-len 16 --new-tokens 32 [--device cpu]

It runs on the GPU unless ``--device cpu`` asks for the plain PyTorch
path; with neither a card nor ``--device cpu`` it raises, naming the GPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import lm

__all__ = ["dense_generate", "main"]


def _sample(logits: torch.Tensor, vocab: int, greedy: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    logits = logits[..., :vocab]  # drop padded classes
    if greedy:  # the first of equal maxima, as jnp.argmax
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def dense_generate(cfg: ArchConfig, params, prompts: torch.Tensor,
                   n_new: int, max_len: int = 512, greedy: bool = True,
                   generator: Optional[torch.Generator] = None,
                   impl: str = "cuda") -> np.ndarray:
    """prompts (B, S0) int on the parameters' device → (B, n_new) generated
    ids.

    Whole-cache prefill, then one decode step per token.  ``impl`` selects
    the MoE dispatch and combine (``'cuda'``: the indirect converter
    kernels on the card; ``'ref'``: their oracles).  Sampling (``greedy``
    False) draws from ``generator``; it cannot repeat the reference's
    ``jax.random`` draws, so only greedy streams compare across packages.
    """
    b, s0 = prompts.shape
    if s0 + n_new > max_len:
        raise ValueError(f"{s0} prompt + {n_new} new tokens exceed max_len "
                         f"{max_len}")
    cache = lm.init_cache(cfg, b, max_len, device=prompts.device)
    logits, cache = lm.prefill(params, {"tokens": prompts}, cache, cfg,
                               impl=impl)
    tok = _sample(logits[:, 0], cfg.vocab, greedy, generator)
    out = []
    for i in range(n_new):
        out.append(tok)
        logits, cache = lm.decode_step(params, tok[:, None], cache, s0 + i,
                                       cfg, impl=impl)
        tok = _sample(logits, cfg.vocab, greedy, generator)
    return torch.stack(out, dim=1).cpu().numpy()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    params = lm.init_model(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    t0 = time.monotonic()
    out = dense_generate(cfg, params, prompts, args.new_tokens,
                         max_len=args.max_len)
    dt = time.monotonic() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"arch={cfg.name} on {dev}: generated {out.shape} in {dt:.2f}s "
          f"({tps:.1f} tok/s)")
    print("sample:", out[0][:16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
