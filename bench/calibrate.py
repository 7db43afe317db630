"""Read the compared numbers of one cell over many seeds in one process,
for setting the limits of ``correct`` (``PERF.md`` §4).

    python3 bench/calibrate.py --workload yi-6b-paged.long-decode \\
        --seeds 11,12,13 --seconds 6 [--control tf32]

Each seed is one run of the cell as ``run.py`` makes it, with a short
window; the process pays its imports and the kernels' loading once.  One
JSON line a run: the seed, ``correct``, every reading and the notes the
comparison left (``kv_gap_by_layer``, the set-up's parts).  ``setup_s``
of any run after the first is not a set-up time.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", default="")
    args = p.parse_args(argv)
    keep = ("readings", "kv_gap_by_layer", "setup_s_parts", "compare_s",
            "requests_checked", "residents_checked", "served_checked",
            "finished", "check_losses", "reference_losses")
    for seed in args.seeds.split(","):
        one = argparse.Namespace(workload=args.workload, seed=int(seed),
                                 seconds=args.seconds, trace=0,
                                 control=args.control)
        r = run.run_cell(one)
        line = {"seed": int(seed), "control": args.control,
                "correct": r["correct"], "checks": r["checks"],
                **{k: r["notes"][k] for k in keep if k in r["notes"]},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        del r
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
