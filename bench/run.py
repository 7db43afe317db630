"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload yi-6b-paged.long-decode --seed 7 \\
        --seconds 40 --trace 0

The cell, its configuration and traffic files, and its metrics are looked
up by name in ``BENCHMARK.json``: the configuration in its ``file``, the
traffic mix in ``bench/traffic/<traffic>.json``, whose ``driver`` names
``bench/drivers/<driver>.py``, and each per-layer metric in
``bench/metrics/<name>.py`` (a ``read(record)`` that returns a number or
``None``).  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, read from the driver's spans and a profiler
slice of the window.

The last line of standard output is one JSON object; the numbers that
decide ``correct`` are also the last lines of standard error.  The run
fails without a result when there is no card or too few, when the
program is missing, or when JAX or the JAX package was loaded.
``--control <name>`` puts a control in the program's place and judges it
as the program is judged, so ``correct`` comes out false: for serving
``tf32`` (the reference computed in TF32) or ``int8`` (the program on
int8 K/V pools), for training ``fp8`` (the reference's products in
float8) or ``half_batch`` (the reference on half of each microbatch).
The benchmark's runs pass none.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):   # the driver's JIT cache
    os.environ.setdefault(var, str(ROOT / "build" / "bench" / sub))
os.environ.setdefault("USE_FLAX", "0")

from harness.common import Ctx, forbidden_modules, load_json  # noqa: E402


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration entry, configuration, traffic) of ``workload``;
    files are looked up under ``root``, a checkout's root."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    return cell, entry, config, traffic


def metrics_of(bench: dict, cell: dict, trace: bool):
    """The cell's metric entries: end-to-end (trace 0) or per-layer."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def run_cell(args, device: str = "cuda", root: Path = ROOT) -> dict:
    """One run; returns the result object (``checks`` last).  ``root``
    holds ``BENCHMARK.json``, the configurations and the traffic mixes
    (the tests give a directory of smoke-sized ones)."""
    bench = load_json(root / "BENCHMARK.json")
    cell, entry, config, traffic = cell_of(bench, args.workload, root)
    config = dict(config, name=entry["name"])
    ctx = Ctx(workload=args.workload, config=config, traffic=traffic,
              seed=args.seed % (1 << 63), seconds=float(args.seconds),
              trace=bool(args.trace), device=device, t0=T0,
              control=args.control)
    driver = load_module(BENCH / "drivers" / f"{traffic['driver']}.py",
                         f"driver_{traffic['driver']}")
    out = driver.run(ctx)

    metrics = {}
    for m in metrics_of(bench, cell, ctx.trace):
        if ctx.trace:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 f"metric_{m['name'].replace('.', '_')}")
            value = reader.read(out.record)
        else:
            value = out.end_to_end.get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    import torch

    on_card = device == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(0) if on_card
                         else "cpu"),
                "count": cell["chips"],
                "memory_peak_bytes": int(out.memory_peak_bytes)}
    if ctx.trace and out.busy_s is not None:
        dev_info.update(busy_s=out.busy_s, window_s=out.window_s)
    result = {"correct": out.correct, "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": dev_info}
    if ctx.trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["notes"] = out.notes
    result["checks"] = {
        c.name: {"value": c.value if math.isfinite(c.value) else None,
                 "limit": c.limit} for c in out.checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="")
    args = p.parse_args(argv)

    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_of(bench, args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args)
    found = forbidden_modules()
    if found:
        print(f"bench: the process loaded {found}, which the benchmark "
              f"must not", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
