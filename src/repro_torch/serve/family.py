"""The ``ServableFamily`` protocol: one scheduler, many model families.

The port's copy of ``repro.serve.family``: the port imports nothing of
``repro``, so it keeps this protocol itself, unchanged.

The scheduler (``repro.serve.scheduler``) implements continuous batching,
SLA-aware admission, eviction with bit-for-bit replay, prefix sharing, and
chaos degradation — none of which is specific to transformers.  What *is*
family-specific is how a sequence's serving state lives in device memory
and what bus traffic touching it costs:

* **Paged attention** (``repro.serve.paged_lm.PagedFamily``): KV state
  grows one token per decode step, lives in fixed-size pages, and every
  access is an *indirect* burst — the page table is the memory-resident
  index vector of the AXI-Pack gather.
* **Recurrent state** (``repro.serve.recurrent_lm.RecurrentFamily``):
  RWKV6/Mamba state is fixed-size per sequence — the degenerate
  "single page that never grows" — and every decode step is a *strided*
  read-modify-write over the (layer, slot) state pool.

The protocol speaks in **resource units** so both map onto the same
admission/eviction arithmetic: a unit is a page for the paged family
(``units_for(n)`` = pages covering ``n`` tokens) and a state slot for
recurrent families (``units_for(n)`` = 1 for any non-empty sequence —
allocated at admission, never grown).  Eviction is identical in both:
``release`` returns the units, and re-admission replays by re-prefill —
``replay(slot)`` resets whatever per-slot state a fresh prefill assumes
(zeroed recurrent state; a no-op for paged families, whose fresh pages
are empty by construction).

The scheduler holds exactly one ``ServableFamily`` and calls nothing
else — no ``isinstance(PagedLM)``, no KV-specific attribute.  Traffic
accounting is part of the protocol (``step_streams`` /
``prefill_account``) so each family reports its own stream dialect:
:class:`repro.core.streams.IndirectStream` page walks for paged KV,
:class:`repro.core.streams.StridedStream` state walks for recurrent
state — and ``BENCH_serving.json`` can compare the two on equal terms.
"""
from __future__ import annotations

import abc
from typing import List, Sequence, Tuple

import numpy as np

from ..core.packing import Traffic

__all__ = ["OutOfPages", "ServableFamily"]


class OutOfPages(RuntimeError):
    """Raised when a resource-unit allocation cannot be satisfied.

    Historically "pages" (the paged KV pool); recurrent families raise it
    when the state pool has no free slot.  The scheduler treats it as
    back-pressure, never as a crash.
    """


class ServableFamily(abc.ABC):
    """Everything the scheduler needs from one servable model family.

    A family binds a model to its resource pool (page pool or state pool)
    and owns all device state; the scheduler only does bookkeeping in
    resource units and records the (Traffic, stream) accounts the family
    hands back.  Implementations: ``PagedFamily`` (``serve/paged_lm.py``)
    and ``RecurrentFamily`` (``serve/recurrent_lm.py``).
    """

    #: Short family label for stats/benchmark rows (e.g. "paged", "rwkv6").
    name: str = "family"

    # -- geometry -----------------------------------------------------------

    @property
    @abc.abstractmethod
    def batch(self) -> int:
        """Number of batch slots (concurrent residents)."""

    @property
    @abc.abstractmethod
    def vocab(self) -> int:
        """Real vocabulary size (sampling never sees padding classes)."""

    @property
    @abc.abstractmethod
    def total_units(self) -> int:
        """Pool capacity in resource units (pages / state slots)."""

    @property
    @abc.abstractmethod
    def free_units(self) -> int:
        """Unallocated resource units right now."""

    @property
    @abc.abstractmethod
    def slot_token_capacity(self) -> int:
        """Max prompt+generation tokens one slot can ever hold."""

    @property
    def page_size(self) -> int:
        """Tokens per unit when units are token-granular (sharing/table
        math); 0 for families whose units are whole-sequence state."""
        return 0

    @property
    @abc.abstractmethod
    def pool_bytes(self) -> int:
        """Device bytes held by the family's resource pool."""

    @abc.abstractmethod
    def units_for(self, n_tokens: int) -> int:
        """Resource units a sequence of ``n_tokens`` occupies."""

    @abc.abstractmethod
    def mapped_units(self, slot: int) -> int:
        """Units currently allocated to ``slot``."""

    @abc.abstractmethod
    def token_capacity(self, slot: int) -> int:
        """Tokens ``slot`` can hold before it must ``grow`` again."""

    @abc.abstractmethod
    def state_bytes(self, n_tokens: int) -> int:
        """Full-width device bytes of serving state for ``n_tokens`` live
        tokens — what a packing-oblivious BASE server streams per touch.
        Linear in ``n_tokens`` for paged KV; constant for recurrent
        state."""

    @abc.abstractmethod
    def lengths(self) -> np.ndarray:
        """Host shadow of per-slot token counts (no device sync)."""

    # -- lifecycle ----------------------------------------------------------

    @abc.abstractmethod
    def alloc_state(self, slot: int, units: int) -> None:
        """Allocate ``units`` more units to ``slot``; raise
        :class:`OutOfPages` (nothing committed) when the pool is short."""

    def grow(self, slot: int, units: int) -> bool:
        """Decode-time growth: like ``alloc_state`` but returns ``False``
        instead of raising, so the scheduler can defer the slot a step."""
        try:
            self.alloc_state(slot, units)
            return True
        except OutOfPages:
            return False

    def trim(self, slot: int, keep_units: int) -> None:
        """Return units beyond ``keep_units`` that hold no live state
        (lookahead reclaim).  Families whose units are never
        over-provisioned may no-op."""

    @abc.abstractmethod
    def release(self, slot: int) -> None:
        """Drop every unit ``slot`` holds (retirement or eviction)."""

    def replay(self, slot: int) -> None:
        """Reset ``slot`` to the state a fresh prefill assumes, so
        re-prefill after eviction rebuilds bit-for-bit.  Called at every
        admission (a fresh prompt is the degenerate zero-token replay).
        Paged families no-op — freshly allocated pages hold no live KV;
        recurrent families zero the slot's state rows."""

    # -- model compute ------------------------------------------------------

    @abc.abstractmethod
    def prefill_batch(self, tokens: np.ndarray, counts: np.ndarray,
                      slots: np.ndarray, starts: np.ndarray):
        """Advance every pending row by one prompt chunk in one launch.

        Same row contract as ``build_prefill_rows``: ``tokens`` (R, C)
        int32, rows with ``counts == 0`` are padding.  Returns the last
        real token's logits per row as a *device* array — the scheduler
        syncs it only at admission boundaries."""

    @abc.abstractmethod
    def decode_steps(self, tokens: np.ndarray, active: np.ndarray,
                     n: int) -> np.ndarray:
        """``n`` fused greedy decode steps; returns the (n, B) host token
        matrix (one sync at the boundary).  Must be bitwise identical to
        ``n`` single steps — the replay guarantee rests on it."""

    # -- speculative decoding (optional) ------------------------------------

    @property
    def spec_k(self) -> int:
        """Speculative verify width: tokens scored per sequence per verify
        launch step.  1 (the default) means the family decodes plainly and
        the scheduler never calls the verify methods below — families
        without a speculative path need to change nothing."""
        return 1

    def verify_steps(self, tokens: np.ndarray, active: np.ndarray,
                     n: int) -> Tuple[np.ndarray, np.ndarray]:
        """``n`` fused draft→verify→accept steps over ``active`` slots.

        Returns ``(toks (n, B, spec_k), counts (n, B))`` host arrays: step
        ``s`` emitted ``counts[s, b]`` tokens for slot ``b``, namely
        ``toks[s, b, :counts[s, b]]`` (one device sync at the boundary).
        Emitted tokens must be bitwise the plain greedy decode sequence —
        the replay guarantee extends to speculation unchanged."""
        raise NotImplementedError(f"{self.name}: no speculative decoding")

    def verify_account(self, lens0: np.ndarray, active: np.ndarray,
                       counts: np.ndarray) -> List[Tuple[Traffic, tuple]]:
        """Per-step (Traffic, stream descriptors) for a verify run that
        just completed — called *after* ``verify_steps`` with the
        pre-launch length shadow ``lens0`` and the emitted ``counts``,
        since speculative context lengths are data-dependent."""
        raise NotImplementedError(f"{self.name}: no speculative decoding")

    # -- traffic accounting -------------------------------------------------

    @abc.abstractmethod
    def step_streams(self, active: np.ndarray,
                     n: int) -> List[Tuple[Traffic, tuple]]:
        """Per-step (Traffic, stream descriptors) for the ``n`` decode
        steps about to run on ``active`` slots.  Called immediately
        before ``decode_steps``; derived from host shadows only."""

    @abc.abstractmethod
    def prefill_account(self, slots: np.ndarray, starts: np.ndarray,
                        counts: np.ndarray) -> Tuple[Traffic, tuple]:
        """(Traffic, stream descriptors) for the prefill chunk that just
        ran over these rows."""

    # -- prefix sharing capability (optional) -------------------------------

    @property
    def supports_prefix_sharing(self) -> bool:
        """Whether units are token-granular and refcounted (paged pools
        with refcounts).  Everything below may raise when this is
        False — the scheduler never calls it then."""
        return False

    def share(self, slot: int, unit_ids: List[int]) -> None:
        raise NotImplementedError(f"{self.name}: no prefix sharing")

    def retain_units(self, unit_ids: List[int]) -> None:
        raise NotImplementedError(f"{self.name}: no prefix sharing")

    def release_units(self, unit_ids: List[int]) -> None:
        raise NotImplementedError(f"{self.name}: no prefix sharing")

    def unit_refcount(self, unit_id: int) -> int:
        raise NotImplementedError(f"{self.name}: no prefix sharing")

    def slot_unit_ids(self, slot: int) -> List[int]:
        raise NotImplementedError(f"{self.name}: no prefix sharing")

    def ensure_writable(self, slot: int, lo_token: int,
                        hi_token: int) -> int:
        """Copy-on-write any shared unit covering [lo, hi]; returns the
        number of copies.  Default: nothing is ever shared, 0 copies."""
        return 0

    def share_account(self, shared_tokens: int,
                      unit_ids: Sequence[int]) -> Tuple[Traffic, tuple]:
        raise NotImplementedError(f"{self.name}: no prefix sharing")

    # -- invariants ---------------------------------------------------------

    @abc.abstractmethod
    def check_integrity(self, retained: int = 0) -> None:
        """Assert the pool's host bookkeeping is self-consistent
        (free/owned partition, refcount conservation with ``retained``
        out-of-table owners, shadow consistency).  Raises
        ``AssertionError`` on the first violation; the chaos suite calls
        this after every scheduler step."""
