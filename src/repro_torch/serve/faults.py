"""Chaos layer for the serving stack: seeded fault plans + invariant checker.

The port's copy of ``repro.serve.faults``, unchanged: it reads only
host-side state, so it serves the port's families as it serves the
reference's.

The scheduler's robustness contract is that contention and faults degrade
service instead of crashing it: pool exhaustion turns into eviction /
preemption / typed rejection, never an exception out of ``run()``.  This
module provides the two tools that lock that contract down:

* :class:`FaultPlan` — a deterministic, seeded schedule of injected faults
  the :class:`repro.serve.Scheduler` consults each step:

  - **forced pool exhaustion** (``exhaust_at``): the scheduler's admission
    and page-growth policy sees zero free pages even though the physical
    free list is intact, driving the reclaim → drop-retained → evict →
    preempt ladder under full pressure;
  - **denied allocations** (``deny_alloc_at``): page allocations fail for
    the step (the mid-flight ``OutOfPages`` scenario) — growth defers the
    starved request to the next step instead of raising;
  - **prefix-index drops** (``drop_prefix_at``): a retained prefix chain is
    dropped from the :class:`repro.serve.PrefixIndex`, exercising the
    re-prefill path (outputs must not change — sharing is an optimization);
  - **injected step latency** (``delay_at``): extra seconds added to the
    observed step wall time and fed to the
    :class:`repro.runtime.fault_tolerance.StragglerWatchdog`, so slow-host
    detection is testable without sleeping.

  Plans are finite: no fault fires past :attr:`FaultPlan.horizon`, which is
  what guarantees liveness (every request reaches a terminal state once the
  chaos window closes).  :meth:`FaultPlan.random` derives a plan purely
  from ``(seed, n_steps, intensities)`` so chaos runs replay bit-for-bit.

* :func:`check_scheduler_invariants` — the step-wise consistency oracle
  chaos tests assert after *every* scheduler step: pool self-consistency
  (via the family's ``check_integrity`` — free/owned partition and
  refcount conservation for paged pools, slot-ownership partition for
  recurrent state pools), slot bookkeeping, no orphaned host shadows, and
  every request in exactly one live or terminal bucket (``done`` /
  ``preempted`` / ``rejected``).  The checker speaks only the
  :class:`repro.serve.family.ServableFamily` protocol, so one oracle
  covers every model family the scheduler serves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "FaultPlan",
    "InvariantViolation",
    "check_scheduler_invariants",
    "terminal_states",
]


class InvariantViolation(AssertionError):
    """A scheduler/pool consistency invariant does not hold."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise InvariantViolation(msg)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic per-step fault schedule (steps are 1-indexed, matching
    ``Scheduler._step``).  All fields are explicit so a failing chaos run's
    plan can be printed and replayed verbatim."""

    seed: int = 0
    exhaust_at: FrozenSet[int] = frozenset()
    deny_alloc_at: FrozenSet[int] = frozenset()
    drop_prefix_at: FrozenSet[int] = frozenset()
    delay_at: Mapping[int, float] = dataclasses.field(default_factory=dict)

    # -- queries (the scheduler's per-step hooks) ---------------------------

    def exhaust(self, step: int) -> bool:
        """Admission/growth must treat the free pool as empty this step."""
        return step in self.exhaust_at

    def deny_alloc(self, step: int) -> bool:
        """Page allocations fail this step (growth defers, never raises)."""
        return step in self.deny_alloc_at

    def drop_prefix(self, step: int) -> bool:
        """Drop a retained prefix chain at the top of this step."""
        return step in self.drop_prefix_at

    def delay(self, step: int) -> float:
        """Injected wall seconds added to this step's observed time."""
        return float(self.delay_at.get(step, 0.0))

    @property
    def horizon(self) -> int:
        """Last step any fault fires; the liveness bound for chaos runs."""
        steps = (set(self.exhaust_at) | set(self.deny_alloc_at)
                 | set(self.drop_prefix_at) | set(self.delay_at))
        return max(steps) if steps else 0

    # -- constructors -------------------------------------------------------

    @classmethod
    def none(cls) -> "FaultPlan":
        return cls()

    @classmethod
    def random(cls, seed: int, n_steps: int = 24, p_exhaust: float = 0.2,
               p_deny: float = 0.15, p_drop: float = 0.1,
               p_delay: float = 0.0, delay_s: float = 0.05) -> "FaultPlan":
        """A seeded plan over scheduler steps ``1..n_steps``.

        Each fault class fires independently per step with its probability;
        past ``n_steps`` the plan is silent, so a random plan always has a
        finite horizon.  The same ``(seed, n_steps, p_*)`` always yields
        the same plan.
        """
        rng = np.random.default_rng(seed)

        def pick(p: float) -> FrozenSet[int]:
            draws = rng.random(n_steps)
            return frozenset(int(s) + 1 for s in np.nonzero(draws < p)[0])

        exhaust = pick(p_exhaust)
        deny = pick(p_deny)
        drop = pick(p_drop)
        delays = {s: delay_s for s in pick(p_delay)}
        return cls(seed=seed, exhaust_at=exhaust, deny_alloc_at=deny,
                   drop_prefix_at=drop, delay_at=delays)


def check_scheduler_invariants(sched, requests: Optional[Sequence] = None,
                               ) -> None:
    """Assert the scheduler + pool consistency invariants; raise
    :class:`InvariantViolation` on the first breach.

    Checked after every step in the chaos suites (and usable anywhere — it
    reads only host-side state, never syncing the device):

    1. **Pool integrity** — the family's own ``check_integrity``:
       free/owned partition and refcount conservation against table
       mappings + prefix retentions for paged pools; slot-ownership
       partition for recurrent state pools.
    2. **Slot bookkeeping** — resident slots are distinct, and together
       with the free-slot stack they partition the batch.
    3. **State discipline** — queued requests are WAITING, residents are
       PREFILL/RUNNING, and the ``finished``/``preempted``/``rejected``
       maps hold exactly their terminal states with disjoint rids.
    4. **Terminal accounting** (with ``requests``) — every submitted
       request is in exactly one live or terminal bucket; a drained
       scheduler has them all terminal.
    """
    from .scheduler import RequestState  # local: avoid an import cycle

    fam = sched.family
    retained = (len(sched.prefix_index.entries)
                if sched.prefix_index is not None else 0)
    fam.check_integrity(retained=retained)

    if sched.prefix_index is not None and fam.supports_prefix_sharing:
        for page in sched.prefix_index.entries.values():
            _require(fam.unit_refcount(int(page)) >= 1,
                     f"retained page {page} has no owner")

    # Slot partition: residents + free slots == all batch slots, no overlap.
    batch = fam.batch
    res_slots = [r.slot for r in sched.resident]
    _require(len(set(res_slots)) == len(res_slots),
             f"duplicate resident slots: {res_slots}")
    _require(all(0 <= s < batch for s in res_slots),
             f"resident slot out of range: {res_slots}")
    _require(not (set(res_slots) & set(sched._free_slots)),
             "slot simultaneously resident and free")
    _require(sorted(res_slots + list(sched._free_slots)) == list(range(batch)),
             "resident + free slots do not partition the batch")

    # State discipline per bucket.
    for r in sched.queue:
        _require(r.state is RequestState.WAITING,
                 f"queued request {r.rid} in state {r.state}")
        _require(r.slot == -1, f"queued request {r.rid} holds slot {r.slot}")
    for r in sched.resident:
        _require(r.state in (RequestState.PREFILL, RequestState.RUNNING),
                 f"resident request {r.rid} in state {r.state}")
    for rid, r in sched.finished.items():
        _require(r.state is RequestState.FINISHED and r.done,
                 f"finished request {rid} in state {r.state}")
    for rid, r in sched.preempted.items():
        _require(r.state is RequestState.PREEMPTED,
                 f"preempted request {rid} in state {r.state}")
        _require(r.slot == -1, f"preempted request {rid} holds a slot")
    for rid, r in sched.rejected.items():
        _require(r.state is RequestState.REJECTED,
                 f"rejected request {rid} in state {r.state}")
        _require(r.reject_reason is not None,
                 f"rejected request {rid} carries no reason")
    terminal_rids = (set(sched.finished) | set(sched.preempted)
                     | set(sched.rejected))
    _require(
        len(terminal_rids) == (len(sched.finished) + len(sched.preempted)
                               + len(sched.rejected)),
        "a request is in more than one terminal bucket")

    # Every submitted request is in exactly one place.
    if requests is not None:
        live = {r.rid for r in sched.queue} | {r.rid for r in sched.resident}
        _require(not (live & terminal_rids),
                 "request simultaneously live and terminal")
        for r in requests:
            n_homes = (int(r.rid in live) + int(r.rid in sched.finished)
                       + int(r.rid in sched.preempted)
                       + int(r.rid in sched.rejected))
            _require(n_homes == 1,
                     f"request {r.rid} is in {n_homes} buckets (want 1)")


def terminal_states(requests) -> Dict[int, str]:
    """rid → terminal state name; raises if any request is still live."""
    out = {}
    for r in requests:
        _require(r.state.value in ("finished", "preempted", "rejected"),
                 f"request {r.rid} never reached a terminal state "
                 f"(stuck in {r.state.value})")
        out[r.rid] = r.state.value
    return out
