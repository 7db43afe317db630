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

* ``dot_flops_per_device``, ``collectives`` (``{kind: {count, payload,
  wire}}``, the reference's summary) and
  ``collective_wire_bytes_per_device``: the step run once as ``meta``
  DTensors over a fake process group of the mesh's size, counted by
  :class:`~repro_torch.launch.step_analysis.StepCounter` (the
  counterpart of the reference's HLO analysis).  The fake group lives in
  a subprocess of its own (:func:`per_device`), so a process that already
  has a group (``chip_smoke.py``) can run it.

Not measured, and ``null`` in the record: temporary bytes (XLA's
``temp_size_in_bytes`` has no torch counterpart).  The reference's TPU
roofline constants are not carried over.

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--no-hlo]

``--no-hlo`` (the reference's switch) skips the FLOP counts and the
collectives.  Each cell runs in a process of its own, ``--jobs N`` of
them at a time (default 1).  A cell whose step cannot run as DTensors
fails the run by name.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..configs import ALL_ARCH_NAMES, applicable_shapes, get_config
from ..models.common import tree_paths
from ..parallel.sharding import shard_shape
from .mesh import make_production_mesh
from .specs import Cell, build_cell

__all__ = ["ARTIFACT_DIR", "NOT_MEASURED", "analyze_per_device",
           "argument_bytes", "card_info", "count_flops", "leaf_records",
           "main", "per_device", "run_cell"]

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")
NOT_MEASURED = {
    "temp_bytes": "XLA's temporary buffers have no torch counterpart",
}
#: Seconds a cell's per-device analysis may take in its subprocess.
PER_DEVICE_TIMEOUT_S = 3 * 3600


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


def analyze_per_device(arch: str, shape: str, multi_pod: bool = False,
                       *, cfg=None, shape_cfg=None, tp: int = 16,
                       mesh=None) -> Dict[str, Any]:
    """The cell's step run once as ``meta`` DTensors over a fake process
    group of the mesh's size (``mesh.fake_group``, in this process, which
    must have no group): ``{dot_flops_per_device, collectives,
    collective_wire_bytes_per_device, ops, seconds}``; ``ops`` lists each
    collective as (kind, payload bytes, group size)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from .mesh import fake_group
    from .specs import dtensor_args
    from .step_analysis import StepCounter, summarize_collectives

    t0 = time.perf_counter()
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    with fake_group(mesh) as bound:
        cell = build_cell(arch, shape, bound, tp=tp, device="meta", cfg=cfg,
                          shape=shape_cfg)
        args = dtensor_args(cell)
        # Plain tensors made inside the step (positions, masks, zeros)
        # take part as replicated.
        with implicit_replication(), StepCounter() as counter:
            cell.step_fn(*args)
    ops = counter.collectives
    return {"dot_flops_per_device": counter.dot_flops,
            "collectives": summarize_collectives(ops),
            "collective_wire_bytes_per_device": math.fsum(
                c.wire_bytes for c in ops),
            "ops": [(c.kind, c.bytes_payload, c.group_size) for c in ops],
            "seconds": time.perf_counter() - t0}


def _src_env() -> Dict[str, str]:
    """This environment with the port's ``src`` first on PYTHONPATH, for
    the subprocesses."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def per_device(arch: str, shape: str, multi_pod: bool = False,
               timeout_s: float = PER_DEVICE_TIMEOUT_S) -> Dict[str, Any]:
    """:func:`analyze_per_device` of a production cell in a subprocess of
    its own (the fake group must not meet this process's group); raises
    with its output if it fails or passes ``timeout_s``."""
    code = ("import json, sys; from repro_torch.launch.dryrun import "
            "analyze_per_device as a; r = a(sys.argv[1], sys.argv[2], "
            "sys.argv[3] == '1'); r.pop('ops'); "
            "print('PER_DEVICE ' + json.dumps(r))")
    try:
        res = subprocess.run(
            [sys.executable, "-c", code, arch, shape,
             "1" if multi_pod else "0"], capture_output=True, text=True,
            timeout=timeout_s, env=_src_env())
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"per-device analysis of {arch} {shape} passed "
                           f"{timeout_s} s") from e
    for line in res.stdout.splitlines():
        if line.startswith("PER_DEVICE ") and res.returncode == 0:
            return json.loads(line[len("PER_DEVICE "):])
    raise RuntimeError(f"per-device analysis of {arch} {shape} failed "
                       f"({res.returncode}):\n{res.stdout[-3000:]}"
                       f"{res.stderr[-6000:]}")


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
        "collectives": None, "collective_wire_bytes_per_device": None,
        "not_measured": dict(NOT_MEASURED),
        "card": card,
        "fits": None if card is None else total <= card["total_memory"],
    }
    if flops:
        t1 = time.perf_counter()
        rec["dot_flops_global"] = count_flops(cell)
        rec["flops_s"] = time.perf_counter() - t1
        per = per_device(arch, shape, multi_pod)
        rec["per_device_s"] = per.pop("seconds")
        rec.update(per)
    else:
        for key in ("dot_flops_global", "dot_flops_per_device",
                    "collectives", "collective_wire_bytes_per_device"):
            rec["not_measured"][key] = "skipped (--no-hlo)"
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


def _tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch:16s} {shape:12s} {'2x16x16' if multi_pod else '16x16'}"


def _summary(rec: Dict[str, Any]) -> str:
    """The CLI line of a record: argument GiB a device, whether it fits,
    global and per-device dot FLOPs, the collectives' wire MiB a device
    (the reference's ``coll=``)."""
    def num(x, fmt):
        return "skipped" if x is None else format(x, fmt)

    wire = rec["collective_wire_bytes_per_device"]
    return (f"args/dev={rec['memory']['argument_gib']:8.3f} GiB "
            f"fits={rec['fits']} flops={num(rec['dot_flops_global'], '.4e')}"
            f" flops/dev={num(rec['dot_flops_per_device'], '.4e')} "
            f"coll={num(None if wire is None else wire / 2**20, '.1f')}MiB")


#: A cell's process (:func:`_run_cells`): argv is arch, shape, multi-pod
#: (0/1), no-hlo (0/1) and the records' directory ('' for the default).
_CELL = """
import sys
from repro_torch.launch.dryrun import _summary, card_info, run_cell
arch, shape, multi_pod, no_hlo, out_dir = sys.argv[1:6]
rec = run_cell(arch, shape, multi_pod == "1", flops=no_hlo == "0",
               out_dir=out_dir or None, card=card_info())
print("SUMMARY " + _summary(rec))
"""


def _run_cells(jobs, args) -> List[str]:
    """Each cell in a process of its own (:data:`_CELL`), ``args.jobs``
    at a time; a line for each, in the order of ``jobs``.  Returns the
    failed cells' tags."""
    from concurrent.futures import ThreadPoolExecutor

    env = _src_env()

    def one(job):
        arch, shape, multi_pod = job
        return subprocess.run(
            [sys.executable, "-c", _CELL, arch, shape,
             "1" if multi_pod else "0", "1" if args.no_hlo else "0",
             args.out_dir or ""], capture_output=True, text=True, env=env)

    failures = []
    with ThreadPoolExecutor(args.jobs) as pool:
        for job, res in zip(jobs, pool.map(one, jobs)):
            tag = _tag(*job)
            lines = [ln for ln in res.stdout.splitlines()
                     if ln.startswith("SUMMARY ")]
            if res.returncode or not lines:
                failures.append(tag)
                print(f"FAIL {tag}: exit {res.returncode}\n"
                      f"{res.stdout[-2000:]}{res.stderr[-4000:]}", flush=True)
            else:
                print(f"OK   {tag} {lines[0][len('SUMMARY '):]}", flush=True)
    return failures


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
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at a time, each in a process of its own")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    card = card_info()
    t0 = time.perf_counter()
    jobs = [(arch, shape, mp) for mp in meshes for arch, shape in cells]
    failures = _run_cells(jobs, args)
    print(f"temp bytes: not measured (no torch counterpart); "
          f"{len(jobs)} cells in {time.perf_counter() - t0:.1f} s "
          f"(host CPU)")
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
