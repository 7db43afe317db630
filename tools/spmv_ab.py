"""The ELL SpMV of one checkout on the card: where its time goes.

Run from the root of a checkout, on one NVIDIA GPU::

    PYTHONPATH=src:. python tools/spmv_ab.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``src/repro_torch`` is imported
(default: this one), so two versions of the kernel can be compared in one
call on one card, in turns (parent, change, change, parent), each in its
own process; the matrices and the timing come from this checkout's
``chip_smoke.py``.  On the spmv workload's matrix (2**22 rows, K = 32,
Poisson(24) live entries, columns uniform) it prints one JSON line: the
card's name and power limit; ``ops.spmv_ell`` and the cuSPARSE CSR matvec
in turns (kernel, library, library, kernel; three rounds), by CUDA events
and by the profiler's device time; the kernel with the columns cut to
2**18, 2**20 and 2**22 distinct x entries (an x of 1, 4 and 16 MB, the
same stream of vals and cols); and a row-local matrix (columns within
2,048 of the row) beside cuSPARSE.  Each result is held within rtol =
atol = 1e-5 of the plain version first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def x_sweep(cs, ops, vals, cols, x):
    """The ELL SpMV's event and profiler times with the matrix's columns
    cut to 2**18, 2**20 and 2**22 distinct x entries (``cols % n``): the
    same stream of vals and cols, an x working set of 1, 4 and 16 MB."""
    out = {}
    for bits in (18, 20, 22):
        cut = cols % (1 << bits)
        run = lambda: ops.spmv_ell(vals, cut, x)
        out[f"2^{bits} columns"] = dict(ms=cs.time_ms(run),
                                        device_ms=cs.profile_ms(run))
        del cut
    return out


def row_local(cs, ops, ref, dev, gen, live):
    """The ELL SpMV on a row-local matrix (the workload's live entries,
    columns uniform within 2,048 of the row, sorted), within TOL of the
    plain version, timed beside cuSPARSE (events and profiler)."""
    import torch

    r, k = live.shape
    near = torch.randint(-2048, 2048, (r, k), generator=gen, device=dev,
                         dtype=torch.int32)
    cols = (torch.arange(r, device=dev, dtype=torch.int32)[:, None] + near)
    cols = torch.where(live, cols.clamp_(0, r - 1), r).sort(dim=1).values
    cols = torch.where(live, cols, 0)
    vals = torch.where(live, torch.randn((r, k), generator=gen, device=dev),
                       0.0)
    x = torch.randn(r, generator=gen, device=dev)
    got, want = ops.spmv_ell(vals, cols, x), ref.spmv_ell(vals, cols, x)
    err = (got - want).abs().max().item()
    cs.require(torch.allclose(got, want, **cs.TOL),
               f"spmv_ell row-local: max abs err {err:.3e} over {cs.TOL}")
    csr = cs.csr_of(vals, cols, live, r)
    run = lambda: ops.spmv_ell(vals, cols, x)
    library = lambda: torch.mv(csr, x)
    return dict(max_abs_err=err, ms=cs.time_ms(run),
                device_ms=cs.profile_ms(run), library_ms=cs.time_ms(library),
                library_device_ms=cs.profile_ms(library))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    if not torch.cuda.is_available():
        print("spmv_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda")
    graph = cs.make_graph(dev)
    vals, cols, live, x = (graph[k] for k in ("vals", "cols", "live", "x"))
    del graph
    kernel = lambda: ops.spmv_ell(vals, cols, x)
    cs.require(torch.allclose(kernel(), ref.spmv_ell(vals, cols, x),
                              **cs.TOL), "spmv_ell: over TOL")
    csr = cs.csr_of(vals, cols, live, x.numel())
    library = lambda: torch.mv(csr, x)
    turns = dict(kernel=[], library=[])
    for _ in range(3):
        for name, fn in (("kernel", kernel), ("library", library),
                         ("library", library), ("kernel", kernel)):
            turns[name].append(dict(ms=cs.time_ms(fn),
                                    device_ms=cs.profile_ms(fn)))
    del csr
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    print(json.dumps(dict(
        label=args.label or str(root), card=smi,
        live_entries=int(live.sum()), in_turns_with_cusparse=turns,
        x_size_sweep=x_sweep(cs, ops, vals, cols, x),
        row_local=row_local(cs, ops, ref, dev, gen, live))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
