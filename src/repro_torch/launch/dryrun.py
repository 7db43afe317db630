"""Dry run of every (arch x shape x mesh) cell on ``meta`` tensors (from
``repro.launch.dryrun``).

Answers "does this config fit, and how much work is it, on a 256- or
512-device mesh?" with no card and no process group:

* ``argument_bytes``: the exact bytes a device holds of the step's
  arguments (each leaf's block under its spec, :func:`~repro_torch.
  parallel.sharding.shard_shape`), split by group: params, optimizer
  state, batch or tokens, cache, scalars;
* ``dot_flops_global``: the step run once on the meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode`` on the plain path
  (``impl='ref'``), every microbatch, layer and prefill chunk counted;
* ``fits``: the argument bytes against the visible card's memory, with
  its name and power limit (``null`` where no card is visible).

Not measured, and ``null`` in the record: temporary bytes (XLA's
``temp_size_in_bytes`` has no torch counterpart), per-device FLOPs and
collectives, which need the step run as DTensors over a mesh (ROADMAP A9c).
The reference's TPU roofline constants are not carried over.

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--no-hlo]

``--no-hlo`` (the reference's switch) skips the FLOP count.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..configs import ALL_ARCH_NAMES, applicable_shapes, get_config
from ..models.common import tree_paths
from ..parallel.sharding import shard_shape
from .mesh import make_production_mesh
from .specs import Cell, build_cell

__all__ = ["ARTIFACT_DIR", "NOT_MEASURED", "argument_bytes", "card_info",
           "count_flops", "leaf_records", "main", "run_cell"]

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")
NOT_MEASURED = {
    "temp_bytes": "XLA's temporary buffers have no torch counterpart",
    "dot_flops_per_device": "needs the step run as DTensors over a mesh "
                            "(ROADMAP A9c)",
    "collectives": "need the step run as DTensors over a mesh under "
                   "CommDebugMode (ROADMAP A9c)",
}


def leaf_records(cell: Cell) -> List[Dict[str, Any]]:
    """Every argument leaf: its group, path, global and per-device shape,
    dtype and per-device bytes, in argument order then sorted key order."""
    out = []
    for group, arg, spec in zip(cell.groups, cell.args, cell.specs):
        specs = dict(tree_paths(spec)) if isinstance(spec, dict) else {
            "": spec}
        for path, t in tree_paths(arg):
            block = shard_shape(t.shape, specs[path], cell.mesh)
            out.append(dict(group=group, path=path, shape=tuple(t.shape),
                            shard_shape=block,
                            dtype=str(t.dtype).replace("torch.", ""),
                            bytes=math.prod(block) * t.element_size()))
    return out


def argument_bytes(cell: Cell) -> Dict[str, int]:
    """Per-device argument bytes by group (in argument order), and their
    ``total``."""
    by = {}
    for rec in leaf_records(cell):
        by[rec["group"]] = by.get(rec["group"], 0) + rec["bytes"]
    by["total"] = sum(by.values())
    return by


def count_flops(cell: Cell) -> int:
    """The FLOPs of one step on the cell's tensors (matrix products and
    the other ops ``FlopCounterMode`` counts), forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    args = [0 if g == "scalars" else a for g, a in zip(cell.groups,
                                                       cell.args)]
    with FlopCounterMode(display=False) as counter:
        cell.step_fn(*args)
    return int(counter.get_total_flops())


def card_info() -> Optional[Dict[str, Any]]:
    """The visible card's name, power limit (as ``nvidia-smi`` gives them)
    and memory, or ``None`` without one."""
    if not torch.cuda.is_available():
        return None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "total_memory": torch.cuda.get_device_properties(0).total_memory}


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             save: bool = True, flops: bool = True,
             out_dir: Optional[os.PathLike] = None,
             card: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build one production cell on ``meta`` tensors and account for it;
    ``card`` (from :func:`card_info`) decides ``fits``."""
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = build_cell(arch, shape, mesh, tp=16, device="meta")
    by = argument_bytes(cell)
    total = by.pop("total")
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh.name, "chips": mesh.size,
        "ok": True, "grad_accum": cell.grad_accum,
        "memory": {"argument_bytes": total, "argument_gib": total / 2**30,
                   "by_group": by},
        "build_s": time.perf_counter() - t0,
        "dot_flops_global": None,
        "temp_bytes": None, "dot_flops_per_device": None,
        "collectives": None, "not_measured": dict(NOT_MEASURED),
        "card": card,
        "fits": None if card is None else total <= card["total_memory"],
    }
    if flops:
        t1 = time.perf_counter()
        rec["dot_flops_global"] = count_flops(cell)
        rec["flops_s"] = time.perf_counter() - t1
    else:
        rec["not_measured"]["dot_flops_global"] = "skipped (--no-hlo)"
    if save:
        d = Path(out_dir) if out_dir is not None else ARTIFACT_DIR
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{arch}__{shape}__{mesh.name}.json"
        path.write_text(json.dumps(rec, indent=1))
        rec["artifact"] = str(path)
    return rec


def all_cells() -> List[tuple]:
    """Every live (arch, shape) pair, the reference's 32."""
    return [(arch, sh.name) for arch in ALL_ARCH_NAMES
            for sh in applicable_shapes(get_config(arch))]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the FLOP count")
    ap.add_argument("--out-dir", default=None,
                    help=f"where the records go (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    card = card_info()
    failures = []
    for multi_pod in meshes:
        for arch, shape in cells:
            mesh = "2x16x16" if multi_pod else "16x16"
            tag = f"{arch:16s} {shape:12s} {mesh}"
            try:
                rec = run_cell(arch, shape, multi_pod, flops=not args.no_hlo,
                               out_dir=args.out_dir, card=card)
            except Exception as e:  # noqa: BLE001 -- report and go on
                failures.append(tag)
                print(f"FAIL {tag}: {e!r}", flush=True)
                traceback.print_exc()
                continue
            fl = rec["dot_flops_global"]
            print(f"OK   {tag} args/dev={rec['memory']['argument_gib']:8.3f} "
                  f"GiB fits={rec['fits']} flops="
                  f"{'skipped' if fl is None else f'{fl:.4e}'}", flush=True)
    print("per-device FLOPs, temp bytes and collectives: not measured "
          "(they need the step run as DTensors over a mesh, ROADMAP A9c)")
    if card is not None:
        print(f"card: {card['nvidia_smi'] or card['name']}, "
              f"{card['total_memory'] / 2**30:.2f} GiB")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        return 1
    print("\nALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
