"""Cycle-approximate banked-memory controller simulator (reproduces Fig. 5)
(numpy copy of ``repro.core.banksim``).

Models the paper's proof-of-concept AXI-Pack endpoint: an adapter translating
packed bursts into sequences of ``n_ports`` parallel word accesses into ``m``
interleaved banks through an n×m crossbar, with per-lane decoupling queues, a
request regulator, and a beat packer.  For indirect bursts, the index stage
and element stage share the word ports through round-robin arbitration, and
element addresses only become available once their index line has been
fetched — exactly the structure of Fig. 2c/2d.

The simulator is the source of PACK-side bank-conflict stalls for the bus
model, and directly reproduces the parameter-sensitivity results of §III-E:

* utilization rises monotonically with bank count (fewer conflicts);
* prime bank counts beat powers of two on strided accesses (stride patterns
  alias modulo 2^k) but show no inherent advantage on indirect accesses;
* larger elements reduce strided conflicts (fewer aligned elements per line);
* indirect utilization is capped at r/(r+1) by index-line port sharing.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from .streams import (
    BurstKind,
    IndirectStream,
    StreamDescriptor,
    StridedStream,
    word_addresses,
)

__all__ = [
    "BankConfig",
    "SimResult",
    "simulate_words",
    "simulate_stream",
    "strided_utilization",
    "indirect_utilization",
    "crossbar_area_kge",
]


@dataclasses.dataclass(frozen=True)
class BankConfig:
    """Endpoint parameters (defaults = the paper's PACK system: 8×17)."""

    n_ports: int = 8          # word ports (= bus_bits / word_bits)
    n_banks: int = 17         # paper's chosen area/perf tradeoff point
    word_bits: int = 32
    queue_depth: int = 4      # decoupling queue depth (32 in §III-E sweeps)
    ideal: bool = False       # conflict-free memory (the 'ideal' curves)


@dataclasses.dataclass
class SimResult:
    cycles: int
    data_beats: int
    utilization: float        # data beats delivered / cycles
    stall_cycles: int         # cycles - ideal cycles


def _bank_of(addr: np.ndarray, n_banks: int) -> np.ndarray:
    return addr % n_banks


def simulate_words(
    word_addrs: np.ndarray,
    cfg: BankConfig,
    index_lines: int = 0,
    words_per_index_line: Optional[int] = None,
    elems_per_index_line: Optional[int] = None,
) -> SimResult:
    """Simulate draining a word-address sequence through the banked endpoint.

    ``word_addrs`` is the element-stage word sequence in stream order; word k
    is issued on lane ``k % n_ports`` (the adapter fetches n words per beat in
    parallel).  If ``index_lines > 0``, an index stage sharing the ports is
    simulated: element addresses of group g unlock only after index line g
    completes, and index/element requests arbitrate round-robin per port.
    """
    n = cfg.n_ports
    words = np.asarray(word_addrs, dtype=np.int64)
    total_words = words.shape[0]
    total_beats = math.ceil(total_words / n)

    if cfg.ideal:
        # One beat per cycle, no conflicts, indices fetched magically.
        cycles = total_beats
        return SimResult(cycles, total_beats, 1.0, 0)

    banks = _bank_of(words, cfg.n_banks)

    # Per-lane element request FIFOs (lane k serves words k, k+n, ...).
    lane_req: List[deque] = [deque() for _ in range(n)]
    # Index-stage request FIFOs (contiguous lines, one word per lane each).
    idx_req: List[deque] = [deque() for _ in range(n)]

    if index_lines > 0:
        epl = elems_per_index_line or n
        # Index lines are contiguous in memory: line g occupies words
        # [g*n, (g+1)*n) of the index array (own address space, interleaved
        # the same way across banks).
        unlock_at_word = [min((g + 1) * epl, total_words) for g in range(index_lines)]
        locked_from = 0  # element words >= this are locked
    else:
        unlock_at_word = []
        locked_from = total_words

    # Pre-split element words into lanes, tracking global word order so we
    # can respect index-unlock boundaries.
    next_word = 0                      # next element word to enqueue
    lanes_filled = 0
    lane_occupancy = [0] * n           # served-but-unpacked words per lane
    served = np.zeros(total_words, dtype=bool)
    next_pack = 0                      # next beat index to pack
    packed_words = 0
    idx_line_issued = 0
    idx_line_done = [0] * max(index_lines, 1)
    idx_words_left: List[int] = []     # outstanding words per in-flight line
    pending_unlocks = deque()

    # Unlock initial element words (everything if no index stage).
    unlocked_until = total_words if index_lines == 0 else 0

    rng_priority = 0  # round-robin bank arbitration pointer
    stage_pref = 0    # round-robin between index (0) and element (1) stages

    cycles = 0
    max_cycles = 64 * (total_words + index_lines * n) + 1024
    idx_inflight: deque = deque()  # (words_remaining, line_id)

    while packed_words < total_words:
        cycles += 1
        if cycles > max_cycles:
            raise RuntimeError("bank simulator failed to converge")

        # --- refill lane request queues from the unlocked element stream ---
        while next_word < unlocked_until and len(lane_req[next_word % n]) < 64:
            lane_req[next_word % n].append(next_word)
            next_word += 1

        # --- index stage: keep one line in flight per free slot -----------
        while (
            index_lines
            and idx_line_issued < index_lines
            and len(idx_inflight) < 4
        ):
            for lane in range(n):
                idx_req[lane].append(idx_line_issued)  # one word per lane
            idx_inflight.append([n, idx_line_issued])
            idx_line_issued += 1

        # --- crossbar arbitration: one grant per bank per cycle -----------
        bank_busy = set()
        grants_elem: List[int] = []
        grants_idx: List[int] = []
        for lane_off in range(n):
            lane = (lane_off + rng_priority) % n
            # Round-robin between stages when both have pending requests.
            choices = []
            if idx_req[lane]:
                choices.append("idx")
            if lane_req[lane] and lane_occupancy[lane] < cfg.queue_depth:
                choices.append("elem")
            if not choices:
                continue
            if len(choices) == 2:
                choice = choices[stage_pref % 2]
            else:
                choice = choices[0]
            if choice == "idx":
                # Index lines are contiguous: word g*n+lane → bank.
                line = idx_req[lane][0]
                bank = (line * n + lane) % cfg.n_banks
                if bank in bank_busy:
                    continue
                bank_busy.add(bank)
                idx_req[lane].popleft()
                grants_idx.append(line)
            else:
                w = lane_req[lane][0]
                bank = int(banks[w])
                if bank in bank_busy:
                    continue
                bank_busy.add(bank)
                lane_req[lane].popleft()
                served[w] = True
                lane_occupancy[lane] += 1
                grants_elem.append(w)
        rng_priority = (rng_priority + 1) % n
        stage_pref ^= 1

        # --- index line completion unlocks element addresses --------------
        for line in grants_idx:
            for rec in idx_inflight:
                if rec[1] == line:
                    rec[0] -= 1
        while idx_inflight and idx_inflight[0][0] == 0:
            _, line = idx_inflight.popleft()
            unlocked_until = unlock_at_word[line]

        # --- beat packer: pop one complete beat per cycle ------------------
        beat_lo = next_pack * n
        beat_hi = min(beat_lo + n, total_words)
        if beat_lo < total_words and served[beat_lo:beat_hi].all():
            for w in range(beat_lo, beat_hi):
                lane_occupancy[w % n] -= 1
            packed_words += beat_hi - beat_lo
            next_pack += 1

    ideal_cycles = total_beats
    return SimResult(
        cycles=cycles,
        data_beats=total_beats,
        utilization=total_beats / cycles,
        stall_cycles=cycles - ideal_cycles,
    )


def simulate_stream(stream: StreamDescriptor, cfg: BankConfig) -> SimResult:
    """Simulate one packed stream through the endpoint."""
    if getattr(stream, "remap_only", False):
        # Prefix-sharing remap: no element payload crosses the endpoint —
        # only the contiguous index-line fetch (the table entries being
        # repointed) drains through the banks.
        assert isinstance(stream, IndirectStream)
        n_words = math.ceil(stream.count * stream.index_bits / cfg.word_bits)
        return simulate_words(np.arange(n_words, dtype=np.int64), cfg)
    words = word_addresses(stream, cfg.word_bits)
    if stream.kind is BurstKind.INDIRECT:
        assert isinstance(stream, IndirectStream)
        bus_bits = cfg.n_ports * cfg.word_bits
        idx_per_line = bus_bits // stream.index_bits
        n_lines = math.ceil(stream.count / idx_per_line)
        elems_per_line = idx_per_line * max(1, stream.elem_bits // cfg.word_bits)
        return simulate_words(
            words,
            cfg,
            index_lines=n_lines,
            elems_per_index_line=elems_per_line,
        )
    return simulate_words(words, cfg)


def strided_utilization(
    stride: int,
    cfg: BankConfig,
    elem_bits: int = 32,
    burst_len: int = 256,
) -> float:
    """Bus utilization for one strided read burst (Fig. 5b protocol)."""
    s = StridedStream(base=0, elem_bits=elem_bits, count=burst_len, stride=stride)
    return simulate_stream(s, cfg).utilization


def indirect_utilization(
    cfg: BankConfig,
    elem_bits: int = 32,
    index_bits: int = 32,
    burst_len: int = 256,
    addr_space: int = 1 << 16,
    seed: int = 0,
) -> float:
    """Bus utilization for one random-index indirect read burst (Fig. 5a)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, addr_space, size=burst_len)
    s = IndirectStream(
        base=0, elem_bits=elem_bits, count=burst_len, indices=idx, index_bits=index_bits
    )
    return simulate_stream(s, cfg).utilization


# ---------------------------------------------------------------------------
# Crossbar area model (Fig. 5c analogue).
#
# The n×m crossbar's datapath grows with n*m*word_bits; bank address
# computation is a cheap mask for power-of-two counts but needs modulo and
# division units for prime counts, whose relative overhead shrinks as the
# datapath grows.  Constants are calibrated once against the paper's reported
# 8-port/32-bit design points (≈55 kGE at 16 banks pow2, with prime overhead
# decreasing from ~40 % at 11 banks to ~15 % at 31 banks).
# ---------------------------------------------------------------------------

_XBAR_KGE_PER_PORTBANKBIT = 55.0 / (8 * 16 * 32)
_MODDIV_KGE_PER_PORT = 2.6  # one modulo + division unit per port


def _is_pow2(x: int) -> bool:
    return x & (x - 1) == 0


def crossbar_area_kge(n_ports: int, n_banks: int, word_bits: int = 32) -> float:
    """Analytic kGE estimate of the n×m bank crossbar (Fig. 5c analogue)."""
    area = _XBAR_KGE_PER_PORTBANKBIT * n_ports * n_banks * word_bits
    if not _is_pow2(n_banks):
        area += _MODDIV_KGE_PER_PORT * n_ports
    return area
