"""The indirect gather and the two SpMVs on the card: routes, plans and the
library calls, timed in turns.

At ``chip_smoke.py``'s shapes (the gather: 24 rows from 256 of 32 KB (fp32
pages), 8 KB (int8 codes) and 256 B (int8 scales); the ELL SpMV: the
workload's 2**22 rows, K = 32, Poisson(24) live entries, C = 2**22; the
panel SpMV: 2**20 rows, K = 32 in 4 steps, panel 512, row blocks of 64,
C = 2**22) it times, with CUDA events and with the profiler's device time
(``chip_smoke.time_ms`` / ``profile_ms``):

* the gather by its own plan, then by plans built here (``plans.GatherPlan``
  launched through ``ops._gather_launch``): 16-byte units with blocks of
  64 to 1024 threads (slabs of 1-16 KB), and 4-byte units with 256;
  ``index_select`` and the launch floor (one 16-byte row);
* the ELL SpMV by its own plan and by plans built here
  (``plans.SpmvPlan`` through ``ops._spmv_launch``: 2 to 32 lanes a row
  with 16-byte loads, so 4 to 1 loads a lane, and 4-byte loads with 8 and
  32 lanes) and the cuSPARSE CSR matvec (``tools/spmv_ab.py`` has the
  x-size sweep and the row-local matrix);
* the panel SpMV on the bulk route and on the cp.async route (x 4 bytes
  off alignment) and the cuSPARSE CSR matvec;
* each default kernel and its library call in turns (kernel, library,
  library, kernel; three rounds), which is how two µs-scale calls compare.

Every result is checked against the plain version first.  A quicker look
than the whole ``chip_smoke.py``.  Needs a GPU; run from the root of a
checkout::

    PYTHONPATH=src:. python tools/stream_breakdown.py
"""
from __future__ import annotations

import json
import subprocess
from dataclasses import replace

import torch

import chip_smoke as cs
from repro_torch.kernels import ops, plans, ref

THREADS = (64, 128, 256, 512, 1024)


def both(fn):
    return dict(ms=cs.time_ms(fn), device_ms=cs.profile_ms(fn))


def in_turns(kernel, library, rounds: int = 3):
    """(kernel, library, library, kernel) event and device times."""
    out = dict(kernel=[], library=[])
    for _ in range(rounds):
        for name, fn in (("kernel", kernel), ("library", library),
                         ("library", library), ("kernel", kernel)):
            out[name].append(both(fn))
    return out


def gather_shape(src, idx):
    """Every plan of interest for the rows of ``src`` gathered by ``idx``."""
    want = ops.indirect_gather(src, idx, impl="ref")
    row = want[0].numel() * want.element_size()

    def forced(plan):
        out = torch.empty_like(want)
        ops._gather_launch(src, idx, out, plan)
        return out

    kernel = lambda: ops.indirect_gather(src, idx)
    idx64 = idx.long()
    library = lambda: torch.index_select(src, 0, idx64)
    cs.require(torch.equal(kernel(), want), "gather: not bitwise")
    default = ops.indirect_gather.plan
    res = {"default plan": dict(both(kernel), route=default.route,
                                threads=default.threads,
                                slab_bytes=default.slab_bytes)}
    for unit, threads in [(16, t) for t in THREADS] + [(4, 256)]:
        slabs = -(-row // (unit * threads))
        if threads > 32 * -(-row // unit // 32):
            continue  # more threads than the row has units
        plan = replace(default, unit=unit, threads=threads, slabs=slabs,
                       grid_y=slabs)
        name = f"{unit}-byte units, {threads} threads"
        cs.require(torch.equal(forced(plan), want),
                   f"gather {name}: not bitwise")
        res[name] = both(lambda: forced(plan))
    res["index_select"] = both(library)
    res["in turns with index_select"] = in_turns(kernel, library)
    return res


def gather_times(dev, gen):
    idx = torch.randperm(256, generator=gen, device=dev)[:24].to(torch.int32)
    pages = torch.randn((256, 8192), generator=gen, device=dev)
    codes = torch.randint(-128, 128, (256, 8192), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    res = {"fp32 32 KB rows": gather_shape(pages, idx),
           "int8 8 KB rows": gather_shape(codes, idx),
           "fp32 256 B rows": gather_shape(pages[:, :64].contiguous(), idx)}
    one_src = torch.zeros((1, 4), device=dev)
    one_idx = torch.zeros(1, dtype=torch.int32, device=dev)
    res["launch floor (one 16 B row)"] = both(
        lambda: ops.indirect_gather(one_src, one_idx))
    return res


def spmv_times(dev, gen):
    """The ELL SpMV at the workload's size by each plan, and beside
    cuSPARSE in turns."""
    graph = cs.make_graph(dev)
    vals, cols, live, x = (graph[k] for k in ("vals", "cols", "live", "x"))
    del graph
    want = ref.spmv_ell(vals, cols, x)
    kernel = lambda: ops.spmv_ell(vals, cols, x)
    cs.require(torch.allclose(kernel(), want, **cs.TOL), "spmv: over TOL")
    default = ops.spmv_ell.plan
    res = {"live_entries": int(live.sum()),
           "default plan": dict(both(kernel), route=default.route)}
    for vec, lanes in ((4, 2), (4, 4), (4, 16), (4, 32), (1, 8), (1, 32)):
        plan = replace(default, vec=vec, lanes=lanes,
                       blocks=-(-vals.shape[0] * lanes // default.threads))
        y = torch.empty_like(want)
        run = lambda: ops._spmv_launch(vals, cols, x, y, plan)
        run()
        cs.require(torch.allclose(y, want, **cs.TOL),
                   f"spmv {plan.route}: over TOL")
        res[plan.route] = both(run)
    csr = cs.csr_of(vals, cols, live, x.numel())
    res["in turns with cuSPARSE"] = in_turns(kernel, lambda: torch.mv(csr, x))
    return res


def panel_times(dev, gen):
    x = torch.rand(cs.SPMV_R, generator=gen, device=dev) * 2 - 1
    x_off = cs.offset_copy(x, 4)
    vals, cols, pids, stray = cs.panel_matrix(
        dev, gen, cs.PANEL_R // cs.PANEL_ROWS, cs.PANEL_ROWS, cs.SPMV_K,
        cs.PANEL_STEPS, cs.SPMV_R, cs.PANEL)
    want = ref.spmv_ell_panel(vals, cols, x, pids, panel=cs.PANEL)
    csr = cs.csr_of(vals, cols, ~stray, x.numel())
    run = {xname: (lambda xv=xv: ops.spmv_ell_panel_kernel(
        vals, cols, xv, pids, panel=cs.PANEL))
        for xname, xv in (("x aligned", x), ("x at +4 B", x_off))}
    run["cuSPARSE CSR matvec"] = lambda: torch.mv(csr, x)
    res = {}
    for name, fn in run.items():
        cs.require(torch.allclose(fn(), want, **cs.TOL),
                   f"panel {name}: over {cs.TOL}")
        res[name] = both(fn)
        if name.startswith("x "):
            res[name]["route"] = ops.spmv_ell_panel_kernel.plan.route
    res["in turns with cuSPARSE"] = in_turns(run["x aligned"],
                                             run["cuSPARSE CSR matvec"])
    return res


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    print(json.dumps({"card": smi, "gather": gather_times(dev, gen),
                      "spmv": spmv_times(dev, gen),
                      "panel": panel_times(dev, gen)}))


if __name__ == "__main__":
    main()
