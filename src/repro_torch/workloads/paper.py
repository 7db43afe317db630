"""The paper's six benchmarks as cycle-model workloads (copy of the model
part of ``benchmarks/paper_workloads.py``, over the port's ``core``).

Each builder turns one workload into :class:`~repro_torch.core.Iteration`
records of stream descriptors; :func:`evaluate` runs the bus model under
BASE, PACK and IDEAL, with the banked endpoint simulator supplying PACK's
bank-conflict stalls, and returns one :class:`Fig3Row`.  The executable
counterparts of the same workloads are in :mod:`.impls`.

Calibration: the constants of :class:`~repro_torch.core.BusConfig`,
shared across all workloads: ``iter_overhead`` (loop/issue),
``reduction_latency`` (Ara's cross-lane reduction tree, calibrated once on
gemv-row's 37 % utilization) and the BASE cycles per narrow element.
Everything else is first-principles from the stream descriptors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core import (
    BankConfig,
    BurstKind,
    BusConfig,
    ContiguousStream,
    IndirectStream,
    Iteration,
    StridedStream,
    System,
    WorkloadModel,
    beats_for,
    simulate_stream,
)

CFG = BusConfig()
BANKS = BankConfig(n_ports=8, n_banks=17, queue_depth=4)

E32 = 32  # fp32 elements / int32 indices


def _conflict_fn(stream):
    """PACK-side bank-conflict stalls from the endpoint simulator.

    The analytic cycle model already charges indirect streams their
    index-line port-sharing term, so only conflict cycles *beyond* the
    analytic cost are added here (no double counting).
    """
    try:
        r = simulate_stream(stream, BANKS)
    except Exception:
        return 0.0
    analytic = r.data_beats
    if stream.kind is BurstKind.INDIRECT:
        analytic += beats_for(stream.count, CFG.bus_bits, stream.index_bits)
    return float(max(0, r.cycles - analytic))


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# Strided workloads
# ---------------------------------------------------------------------------


def ismt_model(n: int = 256) -> WorkloadModel:
    """In-situ transpose: swap row-part and column-part of each row.

    Column access = stride-n stream.  Read-write ordering serializes the
    iteration (the paper's 50 % read-bus ceiling on ismt).
    """
    its = []
    for i in range(n - 1):
        m = n - 1 - i
        its.append(Iteration(
            streams=[
                ContiguousStream(base=0, elem_bits=E32, count=m),
                StridedStream(base=0, elem_bits=E32, count=m, stride=n),
                ContiguousStream(base=0, elem_bits=E32, count=m),
                StridedStream(base=0, elem_bits=E32, count=m, stride=n),
            ],
            compute_ops=2 * m,
            serialize=True,
        ))
    return WorkloadModel("ismt", its, CFG, _conflict_fn)


def gemv_model(n: int = 256, dataflow: str = "col") -> WorkloadModel:
    """gemv: row-wise = contiguous + reduction; col-wise = strided, no reduction."""
    its = []
    if dataflow == "col":
        for _ in range(n):
            its.append(Iteration(
                streams=[StridedStream(base=0, elem_bits=E32, count=n, stride=n)],
                compute_ops=n,
            ))
    else:
        for _ in range(n):
            its.append(Iteration(
                streams=[ContiguousStream(base=0, elem_bits=E32, count=n)],
                compute_ops=n,
                reductions=1,
                reduction_width=n,
            ))
    return WorkloadModel(f"gemv-{dataflow}", its, CFG, _conflict_fn)


def trmv_model(n: int = 256, dataflow: str = "col") -> WorkloadModel:
    """Upper-triangular gemv: stream lengths shrink along the matrix."""
    its = []
    for j in range(1, n + 1):
        if dataflow == "col":
            its.append(Iteration(
                streams=[StridedStream(base=0, elem_bits=E32, count=j, stride=n)],
                compute_ops=j,
            ))
        else:
            its.append(Iteration(
                streams=[ContiguousStream(base=0, elem_bits=E32, count=j)],
                compute_ops=j, reductions=1, reduction_width=j,
            ))
    return WorkloadModel(f"trmv-{dataflow}", its, CFG, _conflict_fn)


# ---------------------------------------------------------------------------
# Indirect workloads (CSR)
# ---------------------------------------------------------------------------


def synth_csr(n_rows: int, avg_nnz: int, n_cols: Optional[int] = None,
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic CSR with heart1-like statistics (SuiteSparse is offline-
    unavailable; heart1: n=3557, ~390 nnz/row)."""
    rng = _rng(seed)
    n_cols = n_cols or n_rows
    counts = np.maximum(1, rng.poisson(avg_nnz, n_rows))
    counts = np.minimum(counts, n_cols)
    indptr = np.zeros(n_rows + 1, np.int64)
    indptr[1:] = np.cumsum(counts)
    indices = np.concatenate([
        np.sort(rng.choice(n_cols, c, replace=False)) for c in counts
    ]).astype(np.int32)
    data = rng.normal(size=indptr[-1]).astype(np.float32)
    return indptr, indices, data


def spmv_model(indptr, indices, name: str = "spmv") -> WorkloadModel:
    """CSR SpMV: per row, stream vals (contig) + x[cols] (indirect) + reduce."""
    its = []
    for r in range(len(indptr) - 1):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        nnz = hi - lo
        if nnz == 0:
            continue
        its.append(Iteration(
            streams=[
                ContiguousStream(base=0, elem_bits=E32, count=nnz),
                IndirectStream(base=0, elem_bits=E32, count=nnz,
                               indices=indices[lo:hi], index_bits=E32),
            ],
            compute_ops=2 * nnz,
            reductions=1,
            reduction_width=nnz,
        ))
    return WorkloadModel(name, its, CFG, _conflict_fn)


def prank_model(indptr, indices) -> WorkloadModel:
    """One PageRank power iteration = SpMV + rank update (axpy per row)."""
    m = spmv_model(indptr, indices, "prank")
    n = len(indptr) - 1
    m.iterations.append(Iteration(
        streams=[ContiguousStream(base=0, elem_bits=E32, count=n),
                 ContiguousStream(base=0, elem_bits=E32, count=n)],
        compute_ops=2 * n,
    ))
    return m


def sssp_model(indptr, indices) -> WorkloadModel:
    """One Bellman-Ford sweep: per row stream weights + dist[cols] (indirect),
    min-reduce, write-back — indirect-read-heavy like spmv but with a
    cheaper combine."""
    its = []
    for r in range(len(indptr) - 1):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        nnz = hi - lo
        if nnz == 0:
            continue
        its.append(Iteration(
            streams=[
                ContiguousStream(base=0, elem_bits=E32, count=nnz),
                IndirectStream(base=0, elem_bits=E32, count=nnz,
                               indices=indices[lo:hi], index_bits=E32),
            ],
            compute_ops=nnz,
            reductions=1,
            reduction_width=nnz,
        ))
    return WorkloadModel("sssp", its, CFG, _conflict_fn)


# ---------------------------------------------------------------------------
# Evaluation helpers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Fig3Row:
    name: str
    speedup_pack: float       # PACK vs BASE
    speedup_ideal: float      # IDEAL vs BASE
    util_pack: float          # read-bus utilization, data beats only
    util_pack_w_index: float
    pack_vs_ideal: float      # fraction of IDEAL performance PACK reaches


def evaluate(model: WorkloadModel) -> Fig3Row:
    r = model.evaluate_all()
    base, pack, ideal = r[System.BASE], r[System.PACK], r[System.IDEAL]
    return Fig3Row(
        name=model.name,
        speedup_pack=base.cycles / pack.cycles,
        speedup_ideal=base.cycles / ideal.cycles,
        util_pack=pack.bus_util,
        util_pack_w_index=pack.bus_util_with_index,
        pack_vs_ideal=ideal.cycles / pack.cycles,
    )


def fig3a_rows(n: int = 256, sparse_rows: int = 256, avg_nnz: int = 390,
               seed: int = 0) -> List[Fig3Row]:
    # heart1-like geometry: 3557 columns regardless of the row subsample
    indptr, indices, _ = synth_csr(sparse_rows, avg_nnz, n_cols=3557, seed=seed)
    rows = [
        evaluate(ismt_model(n)),
        evaluate(gemv_model(n, "col")),
        evaluate(trmv_model(n, "col")),
        evaluate(spmv_model(indptr, indices)),
        evaluate(prank_model(indptr, indices)),
        evaluate(sssp_model(indptr, indices)),
    ]
    return rows
