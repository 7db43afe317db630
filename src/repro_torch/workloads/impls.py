"""The paper's six workloads as PyTorch code on the port's kernels.

The counterpart of ``benchmarks/workload_impls.py``: the same functions,
signatures and defaults, each returning its result and the exact
packed-vs-base traffic efficiencies of its streams
(``{"base_eff", "pack_eff"}``, from :mod:`repro_torch.core.packing`).

* ``ismt`` runs the tiled-transpose kernel (``ops.tiled_transpose``).
* ``spmv`` and ``pagerank`` run the ELL SpMV kernel (``ops.spmv_ell``);
  ``pagerank`` keeps the reference's default ``impl='ref'``, so a caller
  asks for the kernel with ``impl='cuda'``.
* ``gemv_col`` and ``trmv`` are ``torch.matmul`` in strict fp32, as the
  reference leaves them to XLA's ``einsum`` outside any Pallas kernel.
* ``sssp`` is plain tensor code (a min-plus SpMV per sweep), as in the
  reference, which has no kernel for it.

The reference's ``lax.scan`` loops are Python loops here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.packing import Traffic, indirect_traffic, strided_traffic
from ..kernels import ops

__all__ = ["gemv_col", "ismt", "pagerank", "spmv", "sssp", "trmv"]


def _eff(t: Traffic) -> Dict[str, float]:
    return {"base_eff": t.base_efficiency, "pack_eff": t.pack_efficiency}


def ismt(x: torch.Tensor, impl: str = "cuda"
         ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """In-situ transpose via packed tile streams."""
    n = x.shape[0]
    out = ops.tiled_transpose(x, block=min(128, n), impl=impl)
    return out, _eff(strided_traffic(count=n * n, elem_bytes=4, stride=n))


def gemv_col(a: torch.Tensor, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Column dataflow: strided column streams, no reductions."""
    n = a.shape[0]
    y = torch.matmul(a, x)
    return y, _eff(strided_traffic(count=n * n, elem_bytes=4, stride=n))


def trmv(a: torch.Tensor, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Upper-triangular matrix-vector product."""
    n = a.shape[0]
    y = torch.matmul(torch.triu(a), x)
    nnz = n * (n + 1) // 2
    return y, _eff(strided_traffic(count=nnz, elem_bytes=4, stride=n))


def spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
         impl: str = "cuda") -> Tuple[torch.Tensor, Dict[str, float]]:
    """ELL SpMV: the indirect gather ``x[cols]``."""
    y = ops.spmv_ell(vals, cols, x, impl=impl)
    nnz = int(vals.shape[0] * vals.shape[1])
    return y, _eff(indirect_traffic(count=nnz, elem_bytes=4, index_bytes=4))


def pagerank(vals: torch.Tensor, cols: torch.Tensor, n: int, iters: int = 20,
             damping: float = 0.85, impl: str = "ref"
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Power iteration on the (column-normalized) adjacency in ELL form:
    one SpMV per iteration."""
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=vals.device)
    for _ in range(iters):
        r = damping * ops.spmv_ell(vals, cols, r, impl=impl) + (1 - damping) / n
    nnz = int(vals.shape[0] * vals.shape[1]) * iters
    return r, _eff(indirect_traffic(count=nnz, elem_bytes=4, index_bytes=4))


def sssp(wvals: torch.Tensor, cols: torch.Tensor, mask: torch.Tensor,
         src: int, n: int, iters: int
         ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Bellman-Ford on an ELL adjacency (min-plus SpMV per sweep).

    dist[v] = min(dist[v], min_u dist[u] + w[u][v]), row-wise:
    candidate[r] = min_k (dist[cols[r,k]] + wvals[r,k]) over the entries
    ``mask`` marks.  Every add and min is the reference's, so the distances
    are bitwise equal.
    """
    inf = torch.tensor(1e30, dtype=torch.float32, device=wvals.device)
    dist = torch.full((n,), 1e30, dtype=torch.float32, device=wvals.device)
    dist[src] = 0.0
    idx = cols.long()
    for _ in range(iters):
        gathered = dist[idx]                                  # indirect stream
        cand = torch.where(mask, gathered + wvals, inf).amin(1)
        dist = torch.minimum(dist, cand)
    nnz = int(wvals.shape[0] * wvals.shape[1]) * iters
    return dist, _eff(indirect_traffic(count=nnz, elem_bytes=4, index_bytes=4))
