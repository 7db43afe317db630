"""Analytical bus-packing performance model (reproduces Fig. 3 / Fig. 5 laws)
(numpy copy of ``repro.core.busmodel``).

The paper evaluates three systems on a D-bit AXI bus:

* **BASE** — stock AXI4.  Contiguous accesses burst at full width; strided and
  indirect accesses issue one *narrow* beat per element (utilization e/D).
  Indices for indirect accesses are fetched to the core as contiguous vector
  loads (packed), then spent issuing element requests.
* **PACK** — AXI-Pack.  Strided and indirect elements are densely packed onto
  the bus by the memory-side controller (utilization → 1, minus bank-conflict
  stalls and iteration overhead).  Indirection is resolved at the endpoint;
  index fetches share the controller's n word ports with element fetches,
  which caps indirect bus utilization at r/(r+1) for element:index ratio r.
* **IDEAL** — per-lane ideal memory: packed, conflict-free, but indices still
  transit to the core (the paper measures up to 20 % of spmv bus time there).

This module turns :mod:`.streams` descriptors into cycle and beat
counts for each system.  It is deliberately simple — a handful of documented
constants shared by *all* benchmarks — because its job is to reproduce the
paper's measured laws from first principles, not to curve-fit each workload.

Cycle model (per stream phase, R/W channel):
  BASE  contiguous: beats = ceil(N*e/D); strided/indirect: beats = N.
  PACK  beats = ceil(N*e/D); plus, for indirect, the element stage stalls
        ceil(N*i/D) port-cycles while the index stage occupies shared ports.
  IDEAL beats = ceil(N*e/D) (+ index transfer beats on the bus, for indirect).

On top of beats, a phase pays ``iter_overhead`` cycles per loop iteration
(address setup, AR issue, scoreboard) and — for PACK — bank-conflict stalls
taken from :mod:`.banksim` when a simulator is supplied.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .streams import (
    BurstKind,
    ContiguousStream,
    IndirectStream,
    StreamDescriptor,
    StridedStream,
    beats_for,
)

__all__ = [
    "BusConfig",
    "PhaseCost",
    "System",
    "stream_cycles",
    "WorkloadModel",
    "indirect_utilization_ceiling",
]


@dataclasses.dataclass(frozen=True)
class BusConfig:
    """Static system parameters (defaults = the paper's PACK system)."""

    bus_bits: int = 256          # D: data bus width
    word_bits: int = 32          # W: bank/word width
    lanes: int = 8               # vector lanes (= bus_bits/word_bits for Ara)
    iter_overhead: float = 5.0   # cycles of loop/issue overhead per iteration
    reduction_latency: float = 18.0  # cross-lane reduction tree (cal.: gemv-row 37%)
    # BASE narrow-access cost per element.  Strided loads serialize address
    # generation + AR issue (~2 cyc/elem); indexed loads pipeline through the
    # already-loaded index registers (~1 cyc/elem).  Calibrated once against
    # Fig. 3a's ismt (5.4×) and spmv (2.4×) and reused for all workloads.
    base_strided_cpe: float = 2.0
    base_indirect_cpe: float = 1.0

    @property
    def words_per_beat(self) -> int:
        return self.bus_bits // self.word_bits


class System:
    BASE = "base"
    PACK = "pack"
    IDEAL = "ideal"
    ALL = (BASE, PACK, IDEAL)


@dataclasses.dataclass
class PhaseCost:
    """Cycle/beat cost of one stream or compute phase."""

    cycles: float = 0.0
    data_beats: int = 0      # bus beats carrying useful stream data
    index_beats: int = 0     # bus beats carrying indices (BASE/IDEAL only)
    bytes_data: int = 0
    bytes_index: int = 0

    def __add__(self, o: "PhaseCost") -> "PhaseCost":
        return PhaseCost(
            self.cycles + o.cycles,
            self.data_beats + o.data_beats,
            self.index_beats + o.index_beats,
            self.bytes_data + o.bytes_data,
            self.bytes_index + o.bytes_index,
        )


def indirect_utilization_ceiling(elem_bits: int, index_bits: int) -> float:
    """The r/(r+1) law of §III-E: ideal indirect bus utilization."""
    r = elem_bits / index_bits
    return r / (r + 1.0)


def stream_cycles(
    stream: StreamDescriptor,
    system: str,
    cfg: BusConfig,
    conflict_stalls: float = 0.0,
) -> PhaseCost:
    """Cycles and beats to move one stream through the given system.

    ``conflict_stalls`` are extra PACK-side cycles from the bank simulator
    (zero for IDEAL; BASE's narrow accesses are port-rate-limited already).
    """
    n, e, d = stream.count, stream.elem_bits, cfg.bus_bits
    packed_beats = beats_for(n, d, e)
    cost = PhaseCost(bytes_data=stream.bytes)

    if stream.kind is BurstKind.BASE:
        # Contiguous bursts are identical on all three systems.
        cost.data_beats = packed_beats
        cost.cycles = packed_beats + (conflict_stalls if system == System.PACK else 0.0)
        return cost

    if stream.kind is BurstKind.STRIDED:
        if system == System.BASE:
            # One narrow beat per element: the bus carries e of D useful bits.
            cost.data_beats = n
            cost.cycles = float(n) * cfg.base_strided_cpe
        elif system == System.PACK:
            cost.data_beats = packed_beats
            cost.cycles = packed_beats + conflict_stalls
        else:  # IDEAL
            cost.data_beats = packed_beats
            cost.cycles = float(packed_beats)
        return cost

    assert isinstance(stream, IndirectStream)
    i = stream.index_bits
    index_line_beats = beats_for(n, d, i)
    cost.bytes_index = stream.index_bytes
    if system == System.BASE:
        # Indices stream to the core as a contiguous (packed) load, then each
        # element is fetched with a narrow beat.
        cost.index_beats = index_line_beats
        cost.data_beats = n
        cost.cycles = float(index_line_beats) + n * cfg.base_indirect_cpe
    elif system == System.PACK:
        # Indices are fetched endpoint-side as whole lines; the index stage
        # shares the n word ports with the element stage (round-robin), so
        # every index line steals one beat-time from element packing: the
        # r/(r+1) ceiling.  Indices never appear on the bus.
        cost.data_beats = packed_beats
        cost.cycles = packed_beats + index_line_beats + conflict_stalls
    else:  # IDEAL: packed conflict-free elements, but indices cross the bus.
        cost.index_beats = index_line_beats
        cost.data_beats = packed_beats
        cost.cycles = float(packed_beats + index_line_beats)
    return cost


def compute_cycles(n_ops: int, cfg: BusConfig) -> float:
    """Cycles for n_ops element-wise vector ops on ``cfg.lanes`` lanes."""
    return math.ceil(n_ops / cfg.lanes)


def reduction_cycles(n_elems: int, cfg: BusConfig) -> float:
    """Cycles for a full vector reduction (lane-serial + tree latency).

    Models Ara's costly cross-lane reductions that make row-wise gemv
    bandwidth-poor (37 % utilization in Fig. 3b).
    """
    return math.ceil(n_elems / cfg.lanes) + cfg.reduction_latency


@dataclasses.dataclass
class Iteration:
    """One loop iteration of a workload: streams moved + compute performed.

    ``streams`` move concurrently with compute (decoupled VLSU): iteration
    time is max(memory time, compute time) + fixed iteration overhead, which
    matches the converging speedup curves of Fig. 3d/e.
    """

    streams: Sequence[StreamDescriptor] = ()
    compute_ops: int = 0
    reductions: int = 0
    reduction_width: int = 0
    serialize: bool = False  # read-write ordering (e.g. ismt swap) serializes
    repeats: int = 1


@dataclasses.dataclass
class WorkloadResult:
    name: str
    system: str
    cycles: float
    data_beats: int
    index_beats: int
    bytes_data: int
    bytes_index: int
    bus_util: float           # useful data beats / total bus-busy cycles
    bus_util_with_index: float

    def speedup_over(self, other: "WorkloadResult") -> float:
        return other.cycles / self.cycles


class WorkloadModel:
    """A benchmark expressed as iterations; evaluated under BASE/PACK/IDEAL."""

    def __init__(
        self,
        name: str,
        iterations: Sequence[Iteration],
        cfg: Optional[BusConfig] = None,
        conflict_fn: Optional[Callable[[StreamDescriptor], float]] = None,
    ):
        self.name = name
        self.iterations = list(iterations)
        self.cfg = cfg or BusConfig()
        # conflict_fn(stream) -> extra PACK stall cycles (from banksim).
        self.conflict_fn = conflict_fn or (lambda s: 0.0)

    def evaluate(self, system: str) -> WorkloadResult:
        cfg = self.cfg
        total = PhaseCost()
        for it in self.iterations:
            mem = PhaseCost()
            for s in it.streams:
                stalls = self.conflict_fn(s) if system == System.PACK else 0.0
                mem = mem + stream_cycles(s, system, cfg, stalls)
            comp = compute_cycles(it.compute_ops, cfg)
            if it.reductions:
                comp += it.reductions * reduction_cycles(it.reduction_width, cfg)
            if it.serialize:
                cycles = mem.cycles + comp + cfg.iter_overhead
            else:
                cycles = max(mem.cycles, comp) + cfg.iter_overhead
            iter_cost = PhaseCost(
                cycles=cycles,
                data_beats=mem.data_beats,
                index_beats=mem.index_beats,
                bytes_data=mem.bytes_data,
                bytes_index=mem.bytes_index,
            )
            for _ in range(it.repeats):
                total = total + iter_cost
        util = total.data_beats / total.cycles if total.cycles else 0.0
        util_w_idx = (
            (total.data_beats + total.index_beats) / total.cycles
            if total.cycles
            else 0.0
        )
        return WorkloadResult(
            name=self.name,
            system=system,
            cycles=total.cycles,
            data_beats=total.data_beats,
            index_beats=total.index_beats,
            bytes_data=total.bytes_data,
            bytes_index=total.bytes_index,
            bus_util=util,
            bus_util_with_index=util_w_idx,
        )

    def evaluate_all(self) -> dict:
        return {s: self.evaluate(s) for s in System.ALL}
