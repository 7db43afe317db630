"""Training launcher of the port: configs → data → step → fault tolerance.

The counterpart of ``repro.launch.train``, with its flags less the mesh::

    python -m repro_torch.launch.train --arch yi-6b --smoke --steps 100 \
        --global-batch 8 --seq-len 128 [--device cpu]

It trains on the GPU, through the flash-attention kernels, unless
``--device cpu`` asks for the plain PyTorch path; with neither a card nor
``--device cpu`` it raises, naming the GPU, before it writes anything.
Without a corpus in ``--data-dir`` it writes the reference's synthetic
one there; checkpoints go to ``--ckpt-dir``, and a run finding one there
resumes from it.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..data import TokenDataset, make_frontend_batch, synthetic_corpus
from ..device import resolve_device
from ..models.common import tree_leaves
from ..models.lm import init_model
from ..optim import OptimizerConfig, make_optimizer
from ..runtime import FaultToleranceConfig, TrainController
from ..train import make_train_step

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tmp, "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-dir",
                    default=os.path.join(tmp, "repro_torch_corpus"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not os.path.exists(os.path.join(args.data_dir, "meta.json")):
        synthetic_corpus(args.data_dir, n_tokens=200_000, vocab=cfg.vocab,
                         seed=args.seed)
    ds = TokenDataset(args.data_dir, args.seq_len, args.global_batch)

    opt = make_optimizer(OptimizerConfig(
        name=cfg.optimizer, lr=args.lr, warmup_steps=20,
        total_steps=args.steps))
    params = init_model(cfg, seed=args.seed, device=dev)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params:,} on {dev} "
          f"({cfg.notes or 'no notes'})")

    train_step = make_train_step(cfg, opt, grad_accum=args.grad_accum)

    def step_fn(state, batch, step):
        p, o, metrics = train_step(state["params"], state["opt"], batch, step)
        return {"params": p, "opt": o}, metrics

    frng = np.random.default_rng(args.seed)

    def make_batch(step):
        b = make_frontend_batch(ds.batch(step), cfg, frng)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    ctl = TrainController(step_fn, make_batch, FaultToleranceConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every))
    ctl.run({"params": params, "opt": opt_state}, args.steps)
    losses = [h["loss"] for h in ctl.history]
    if losses:
        print(f"first-5 loss {np.mean(losses[:5]):.4f} → last-5 "
              f"{np.mean(losses[-5:]):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
