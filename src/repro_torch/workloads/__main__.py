"""The paper's irregular workloads on the port, checked against numpy.

The counterpart of ``examples/sparse_ops.py``.  Each workload prints its
verified result, its packed-vs-base traffic efficiency (the measured
counterpart of Fig. 3) and the modeled BASE/PACK/IDEAL speed-up from the
bus model and the banked endpoint simulator::

    python -m repro_torch.workloads              # on the GPU
    python -m repro_torch.workloads --device cpu # the plain PyTorch path

Without ``--device`` it runs on the GPU and raises where there is none.
On the GPU ismt, spmv and pagerank launch the CUDA kernels (pagerank with
``impl='cuda'``, where the reference's example keeps its default
``'ref'``); on the CPU they run the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import csr_to_ell
from . import impls as W
from .paper import (evaluate, gemv_model, ismt_model, prank_model, spmv_model,
                    sssp_model, synth_csr, trmv_model)

__all__ = ["main", "run"]


def _dense(indptr, indices, data, n: int) -> np.ndarray:
    dense = np.zeros((n, n), np.float32)
    for r in range(n):
        dense[r, indices[indptr[r]:indptr[r + 1]]] = data[indptr[r]:indptr[r + 1]]
    return dense


def _csr(dense: np.ndarray):
    indptr, indices, data = [0], [], []
    for row in dense:
        nz = np.nonzero(row)[0]
        indices.extend(nz)
        data.extend(row[nz])
        indptr.append(len(indices))
    return (np.asarray(indptr), np.asarray(indices, np.int32),
            np.asarray(data, np.float32))


def run(device=None, n: int = 128, seed: int = 0, prank_iters: int = 40,
        sssp_iters: int = 12) -> List[Dict]:
    """Run the six workloads at size ``n`` on ``device`` (``None``: the
    GPU), check each against numpy, and return one record per workload:
    its check, traffic efficiencies and modeled Fig. 3 row.  A failed check
    raises ``AssertionError``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = []

    # ismt: strided tile streams.
    a = rng.normal(size=(n, n)).astype(np.float32)
    at, tr = W.ismt(t(a))
    assert np.array_equal(at.cpu().numpy(), a.T), "ismt: not the transpose"
    out.append(dict(name="ismt", check="bitwise transpose", **tr,
                    model=evaluate(ismt_model(n))))

    # gemv / trmv: column-dataflow strided streams.
    x = rng.normal(size=(n,)).astype(np.float32)
    y, tr = W.gemv_col(t(a), t(x))
    assert np.allclose(y.cpu().numpy(), a @ x, rtol=1e-4,
                       atol=1e-4), "gemv_col"
    out.append(dict(name="gemv_col", check="allclose a @ x", **tr,
                    model=evaluate(gemv_model(n, "col"))))
    y, tr = W.trmv(t(a), t(x))
    assert np.allclose(y.cpu().numpy(), np.triu(a) @ x, rtol=1e-4,
                       atol=1e-4), "trmv"
    out.append(dict(name="trmv", check="allclose triu(a) @ x", **tr,
                    model=evaluate(trmv_model(n, "col"))))

    # spmv / pagerank / sssp: indirect streams over CSR -> ELL.
    indptr, indices, data = synth_csr(n, 24, n_cols=n, seed=1)
    vals, cols = csr_to_ell(indptr, indices, data, n)
    dense = _dense(indptr, indices, data, n)
    y, tr = W.spmv(t(vals), t(cols), t(x))
    assert np.allclose(y.cpu().numpy(), dense @ x, rtol=1e-4,
                       atol=1e-4), "spmv"
    out.append(dict(name="spmv", check="allclose dense @ x", **tr,
                    model=evaluate(spmv_model(indptr, indices))))

    adj = (np.abs(dense) > 0).astype(np.float32) + np.eye(n, dtype=np.float32)
    p_dense = adj / adj.sum(0, keepdims=True)
    pvals, pcols = csr_to_ell(*_csr(p_dense), n)
    ranks, tr = W.pagerank(t(pvals), t(pcols), n, iters=prank_iters,
                           impl="cuda")
    want = np.full(n, 1.0 / n, np.float32)
    for _ in range(prank_iters):
        want = 0.85 * (p_dense @ want) + 0.15 / n
    ranks = ranks.cpu().numpy()
    assert np.allclose(ranks, want, rtol=1e-4, atol=1e-7), "pagerank"
    out.append(dict(name="pagerank", check="allclose dense power iteration",
                    **tr, sum=float(ranks.sum()), top=int(ranks.argmax()),
                    model=evaluate(prank_model(indptr, indices))))

    mask = vals != 0
    wv = (np.abs(vals) + mask * 0.1).astype(np.float32)
    dist, tr = W.sssp(t(wv), t(cols), t(mask), src=0, n=n, iters=sssp_iters)
    dist = dist.cpu().numpy()
    want = np.full(n, np.float32(1e30))
    want[0] = 0.0
    for _ in range(sssp_iters):
        cand = np.where(mask, want[cols] + wv, np.float32(1e30)).min(1)
        want = np.minimum(want, cand)
    assert np.array_equal(dist, want), "sssp: not the numpy Bellman-Ford"
    out.append(dict(name="sssp", check="bitwise numpy Bellman-Ford", **tr,
                    reachable=int((dist < 1e29).sum()),
                    model=evaluate(sssp_model(indptr, indices))))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.workloads",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--n", type=int, default=128, help="matrix size")
    args = ap.parse_args(argv)
    rows = run(args.device, n=args.n)
    for r in rows:
        m = r["model"]
        extra = ""
        if "sum" in r:
            extra = f" | sums to {r['sum']:.3f}, top node {r['top']}"
        if "reachable" in r:
            extra = f" | {r['reachable']}/{args.n} reachable"
        print(f"{r['name']:8s} ok ({r['check']}) | traffic eff base "
              f"{r['base_eff']:.2f} -> pack {r['pack_eff']:.2f} | modeled "
              f"speedup {m.speedup_pack:.2f}x, PACK bus util "
              f"{m.util_pack:.1%}{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
