"""Continuous-batching request scheduler over AXI-Pack stream families.

The port's copy of ``repro.serve.scheduler``.  The one change is at the
admission boundary, where the prefill logits (a torch tensor, possibly on
the GPU) cross to the host with ``.cpu().numpy()``.

The serving-side payoff of the paper's irregular streams: a fixed physical
resource pool, per-sequence descriptors as memory-resident index vectors,
and a scheduler that keeps the pool full of *useful* state.  Requests of
arbitrary length enter and leave mid-flight; every decode step is one
batched fused launch whose operands — and whose BASE-vs-PACK traffic
accounting — come from the family's own stream descriptors.

The scheduler is **family-agnostic**: it drives exactly one
:class:`repro.serve.family.ServableFamily` and speaks only the protocol —
resource *units* (pages for paged attention, state slots for recurrent
models), ``prefill_batch``/``decode_steps`` for compute,
``step_streams``/``prefill_account`` for accounting, and
``alloc_state``/``grow``/``release``/``replay`` for the lifecycle.  No
``isinstance`` check or KV-specific attribute appears below; the paged
transformer path (``repro.serve.paged_lm.PagedFamily``, indirect page-walk
streams) and the recurrent path (``repro.serve.recurrent_lm``, strided
state streams) run through the same code.

Scheduling policy (vLLM-shaped, deliberately simple and deterministic):

* **Admission** — priority/deadline ordered.  The queue sorts by
  ``(priority desc, absolute deadline asc, submission order)``; with the
  defaults (priority 0, no deadline) this is exactly FIFO.  The head of the
  queue is admitted when a batch slot is free and the pool holds units for
  its whole prompt plus one decode unit of headroom (head-of-line blocking
  is deliberate: it keeps admission deterministic and starvation-free).
  Prompt units are allocated at admission; decode units on demand.
  Requests that can *never* be served — worst-case units exceed the pool,
  or the prompt+generation exceeds the per-slot token capacity — are
  rejected at ``submit()`` with a typed, non-fatal :class:`RequestRejected`
  (reason ``NEVER_FITS``); a ``deadline_steps`` too tight to ever meet is
  rejected as ``DEADLINE_INFEASIBLE``; and a queued request whose deadline
  expires while the pool is busy is rejected as ``POOL_BUSY`` instead of
  being served late.  Rejection is a terminal state (``rejected``) tracked
  next to ``finished`` — it never poisons the scheduler.
* **Preemption** — when unit growth or admission hits pool exhaustion the
  scheduler evicts the resident with the *lowest priority*, tie-broken by
  the cheapest replay cost (prompt + generated tokens — exactly the work
  replay must redo), then by youth.  Each eviction charges the victim's
  ``replay_budget`` (tokens; ``None`` = unlimited); a victim whose budget
  is exhausted transitions to the terminal ``preempted`` state (partial
  output retained in ``generated``) instead of re-entering the queue.
* **Fault injection** — an optional :class:`repro.serve.faults.FaultPlan`
  drives chaos testing: forced pool exhaustion (admission/growth see zero
  free units), denied allocations (growth defers the starved request a
  step), prefix-index drops, and injected step latency fed to an optional
  ``StragglerWatchdog``.  Faults reroute through the same degradation
  ladder as real pressure — reclaim lookahead → drop retained prefixes →
  evict/preempt — and never raise out of ``run()``.  A fault action the
  family cannot express (a prefix drop against a family with no prefix
  index) no-ops with a counted skip (``stats.n_prefix_drop_skips``).
* **Prefill** — chunked and batched: each scheduler step advances *every*
  pending request by one fixed-size chunk in a single family
  ``prefill_batch`` call, interleaved with decode (prefill never starves
  decode and vice versa).  Each prefill step records the family's
  ``prefill_account`` descriptors the way decode steps record theirs.
* **Decode fast path** — between scheduling boundaries (admission, prefill,
  unit growth, retirement) every decode quantity is known on the host, so
  the scheduler *fuses* all steps up to the next boundary into one
  ``decode_steps`` call (device-resident sampling, pools donated in place)
  and syncs the token matrix back exactly once per boundary.  When nothing
  can be admitted or prefilled first, units for each request's remaining
  generation are preallocated from the free pool (lookahead never evicts),
  so growth stops being a boundary.  Per-step records come from the
  family's ``step_streams`` (host shadows only), so the PACK-vs-BASE
  accounting is unchanged from the step-at-a-time path.
* **Eviction** — when a decode step needs a unit and the pool is empty, the
  *youngest* resident request is preempted: its units return to the pool and
  it re-enters the queue front.  On re-admission ``replay(slot)`` resets
  the slot to what a fresh prefill assumes (a no-op for paged families;
  zeroed state rows for recurrent ones), its prompt is re-prefilled, and
  its previously generated tokens are *replayed through the decode path*
  (outputs discarded), which rebuilds its serving state bit-for-bit — so
  eviction is invisible in the output stream.  Replay inputs are forced
  from the recorded tokens at every fused-launch boundary; *within* a
  fused launch the device feeds its own greedy argmax, which matches the
  recorded tokens because the model is deterministic and row-wise (the
  property the equivalence tests assert) — a future nondeterministic
  kernel would have to cap fusion during replay.
* **Prefix sharing** (opt-in, ``prefix_sharing=True``; requires
  ``family.supports_prefix_sharing`` — token-granular refcounted units) —
  a :class:`PrefixIndex` maps page-aligned prompt chunks to the physical
  units that hold them.  Admission looks the new prompt up and maps every
  matched unit by refcount bump (``family.share``), prefilling only the
  divergent tail; completed prefills register their full prompt units, and
  retired requests' units are *retained* by the index (LRU) so later
  requests on the same system prompt hit the pool without it being
  resident.  Writes never land in a shared unit: admission privatizes the
  boundary unit up front via copy-on-write (``ensure_writable``), and the
  prefill/decode paths carry the same guard defensively.  Under pool
  pressure retained units are dropped LRU-first before any resident is
  evicted; eviction/replay re-derives shared mappings through the same
  lookup, so replay stays bit-for-bit (shared units are reused, never
  re-quantized differently in int8 mode).  Admission briefly *defers* a
  request whose prefix is still being prefilled by a resident sibling, so
  concurrent arrivals with one system prompt share it instead of each
  prefilling privately.
* **Hooks** — ``on_token(request, token)`` streams each newly generated
  token; ``on_finish(request)`` fires at completion.

Every decode step records a :class:`repro.core.packing.Traffic`: BASE is
the padded contiguous state a packing-oblivious server would stream, PACK
is the mapped units plus the near-memory descriptor fetch — connecting
serving throughput back to the Fig. 3 bus model.  The stream dialect is
the family's: :class:`repro.core.streams.IndirectStream` page walks for
paged KV (8-bit element width under int8 pools), strided read-modify-write
:class:`repro.core.streams.StridedStream` pairs for recurrent state.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import OrderedDict
from typing import (
    Any, Callable, Dict, FrozenSet, Iterator, List, Optional, Sequence,
    Tuple,
)

import numpy as np

from ..core.packing import Traffic
from .family import ServableFamily
from .faults import FaultPlan

__all__ = [
    "PrefixIndex",
    "RejectReason",
    "Request",
    "RequestRejected",
    "RequestState",
    "Scheduler",
    "SchedulerStalledError",
    "StepRecord",
    "ServeStats",
    "build_prefill_rows",
]


class RejectReason(enum.Enum):
    """Why a request was rejected instead of served.

    * ``NEVER_FITS`` — the request's worst-case unit demand exceeds the
      pool, or its prompt+generation exceeds the per-slot token capacity;
      no amount of waiting can serve it.
    * ``POOL_BUSY`` — the request has a deadline, and by the time the busy
      pool could admit it the deadline can no longer be met.  With no
      deadline a request waits indefinitely instead.
    * ``DEADLINE_INFEASIBLE`` — the deadline is shorter than the minimum
      scheduler steps the request needs even on an idle pool.
    """

    NEVER_FITS = "never-fits"
    POOL_BUSY = "pool-busy"
    DEADLINE_INFEASIBLE = "deadline-infeasible"


class RequestRejected(RuntimeError):
    """Typed, non-fatal rejection: the scheduler stays fully consistent.

    Raised from ``submit(..., strict=True)`` (the default) so misuse is
    loud; with ``strict=False`` the rejection is recorded silently in
    ``Scheduler.rejected`` and submit returns ``False``.  Either way the
    request ends in the terminal ``REJECTED`` state with
    ``request.reject_reason`` set.
    """

    def __init__(self, request: "Request", reason: RejectReason, detail: str):
        super().__init__(
            f"request {request.rid} rejected ({reason.value}): {detail}"
        )
        self.request = request
        self.reason = reason


class SchedulerStalledError(RuntimeError):
    """``run()`` hit ``max_steps`` with work still pending.

    The message carries a full diagnostic dump — queue depth, free
    units/slots, and per-request state (rid, state, slot, prefill position,
    generated count, KV length, priority) — so a stall names the stuck
    request instead of leaving a context-free failure.
    """


class PrefixIndex:
    """Prompt-prefix → physical-unit index over page-aligned token chunks.

    Entry ``k`` of a prompt is keyed by the byte string of its first
    ``(k+1)·page`` tokens and maps to the physical page holding tokens
    ``[k·page, (k+1)·page)``.  Keying each page by the *cumulative* chunk
    (not just its own tokens) makes the mapping exact — two prompts share
    entry ``k`` iff they agree on every token up to that page boundary — so
    a lookup walk needs no verification pass and cannot alias.

    The index holds one refcount owner per registered page
    (``family.retain_units``), which is what keeps a retired prompt's
    prefix resident.  Entries are LRU-ordered; the scheduler drops them
    oldest-first under pool pressure.  Only meaningful for families with
    token-granular refcounted units (``supports_prefix_sharing``).
    """

    def __init__(self, page_size: int):
        self.page = page_size
        #: key → physical page id, in LRU order (oldest first).
        self.entries: "OrderedDict[bytes, int]" = OrderedDict()

    def chunks(self, prompt) -> Iterator[bytes]:
        """Cumulative page-aligned chunk keys of ``prompt``, in order."""
        pr = np.ascontiguousarray(np.asarray(prompt, dtype=np.int64))
        for k in range(len(pr) // self.page):
            yield pr[: (k + 1) * self.page].tobytes()

    def prefix_keys(self, prompt, n: int) -> FrozenSet[bytes]:
        """The first ``n`` chunk keys of ``prompt`` (a lookup's match set)."""
        out = []
        for k, key in enumerate(self.chunks(prompt)):
            if k >= n:
                break
            out.append(key)
        return frozenset(out)

    def match_len(self, prompt) -> int:
        """Longest indexed prefix of ``prompt``, in pages (LRU untouched)."""
        n = 0
        for key in self.chunks(prompt):
            if key not in self.entries:
                break
            n += 1
        return n

    def lookup(self, prompt) -> List[int]:
        """Physical pages of the longest indexed prefix; refreshes LRU."""
        ids: List[int] = []
        for key in self.chunks(prompt):
            page_id = self.entries.get(key)
            if page_id is None:
                break
            self.entries.move_to_end(key)
            ids.append(page_id)
        return ids

    def register(self, prompt, page_ids: Sequence[int]) -> List[int]:
        """Index ``prompt``'s full pages; returns the newly retained ones.

        Existing entries win (first prefill of a prefix is the canonical
        copy) — the caller must bump refcounts for exactly the returned
        pages.
        """
        new: List[int] = []
        for k, key in enumerate(self.chunks(prompt)):
            if k >= len(page_ids):
                break
            if key in self.entries:
                self.entries.move_to_end(key)
                continue
            self.entries[key] = int(page_ids[k])
            new.append(int(page_ids[k]))
        return new

    def pop_chain(self, key: bytes,
                  keep: FrozenSet[bytes] = frozenset()) -> List[int]:
        """Drop ``key`` and every entry extending it; returns their pages.

        Dropping the extensions keeps every remaining entry reachable from
        a fresh lookup walk (an entry whose ancestor is gone could never be
        matched again and would leak its retention).  ``keep`` protects a
        chain a pending admission has just matched.
        """
        pages: List[int] = []
        for k2 in [k for k in self.entries if k.startswith(key)]:
            if k2 in keep:
                continue
            pages.append(self.entries.pop(k2))
        return pages

    def pop_all(self) -> List[int]:
        """Drop every entry; returns all retained pages."""
        pages = list(self.entries.values())
        self.entries.clear()
        return pages


def build_prefill_rows(
    items: Sequence[Tuple[np.ndarray, int, int]], chunk: int, batch: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Assemble one batched-prefill call from pending (prompt, start, slot)s.

    Rows are pow2-bucketed to the pending count (never padded to the full
    batch): compute scales with actual prefill work while the jit cache
    stays O(log batch).  Returns ``(tokens (R, chunk), counts, slots,
    starts)`` with zero-filled padding rows past the pending set.  Single
    source of the bucketing/assembly shared by ``Scheduler._prefill_all``
    and the serving benchmark's isolated prefill phase — so the benchmark
    times exactly the calls the scheduler issues.
    """
    rows = min(1 << max(len(items) - 1, 0).bit_length(), batch)
    toks = np.zeros((rows, chunk), np.int32)
    counts = np.zeros((rows,), np.int32)
    slots = np.zeros((rows,), np.int32)
    starts = np.zeros((rows,), np.int32)
    for i, (prompt, start, slot) in enumerate(items):
        count = min(chunk, len(prompt) - start)
        toks[i, :count] = prompt[start:start + count]
        counts[i], slots[i], starts[i] = count, slot, start
    return toks, counts, slots, starts


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    FINISHED = "finished"    # terminal: completed max_new tokens
    PREEMPTED = "preempted"  # terminal: evicted with replay budget exhausted
    REJECTED = "rejected"    # terminal: never admitted (see RejectReason)


#: The states a request can end in — every submitted request reaches
#: exactly one of these (the chaos suite's terminal-accounting invariant).
TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.PREEMPTED, RequestState.REJECTED,
})


@dataclasses.dataclass
class Request:
    """One generation request.

    ``generated`` includes every sampled token (the first comes from the
    prompt's last prefill logits).  ``fed`` counts decode inputs consumed
    since the last (re-)prefill: while ``fed + 1 < len(generated)`` the
    request is replaying after an eviction and decode outputs are discarded.

    SLA fields: ``priority`` orders admission and shields against
    preemption (higher wins; default 0).  ``deadline_steps`` bounds the
    scheduler steps from submission to completion — an infeasible deadline
    is rejected at submit, and one that expires while queued is rejected
    as pool-busy rather than served late.  ``replay_budget`` caps the total
    tokens (prompt + generated) this request may replay across evictions;
    exhausting it turns the next eviction into the terminal ``preempted``
    state with the partial output retained.
    """

    rid: int
    prompt: np.ndarray
    max_new: int
    priority: int = 0
    deadline_steps: Optional[int] = None
    replay_budget: Optional[int] = None
    on_token: Optional[Callable[["Request", int], None]] = None
    on_finish: Optional[Callable[["Request"], None]] = None

    state: RequestState = RequestState.WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    prefill_pos: int = 0      # prompt tokens already prefilled
    fed: int = 0              # decode inputs consumed since (re-)prefill
    n_evictions: int = 0
    admit_order: int = -1
    replay_spent: int = 0     # tokens charged against replay_budget so far
    submit_step: int = -1
    finish_step: int = -1
    reject_reason: Optional[RejectReason] = None
    _order: int = -1          # submission sequence (queue tie-break)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    @property
    def replaying(self) -> bool:
        return self.fed + 1 < len(self.generated)

    @property
    def replay_cost(self) -> int:
        """Tokens an eviction would force back through the model: the full
        prompt re-prefills and every generated-so-far token re-decodes."""
        return self.prompt_len + len(self.generated)

    @property
    def deadline_step(self) -> float:
        """Absolute step this request must finish by (inf if no deadline)."""
        if self.deadline_steps is None:
            return float("inf")
        return self.submit_step + self.deadline_steps


@dataclasses.dataclass
class StepRecord:
    """Per-model-step accounting (a fused launch emits one record per step).

    ``streams`` holds the family's descriptor dialect —
    ``IndirectStream`` page walks for paged KV, ``StridedStream``
    read-modify-write pairs for recurrent state.
    """

    step: int
    kind: str                 # 'decode' | 'verify' | 'prefill' | 'share'
    n_active: int
    new_tokens: int
    traffic: Optional[Traffic]
    streams: Tuple[Any, ...] = ()


@dataclasses.dataclass
class ServeStats:
    records: List[StepRecord] = dataclasses.field(default_factory=list)
    n_evictions: int = 0            # evict-and-requeue events (replayable)
    wall_s: float = 0.0
    prefill_tokens_saved: int = 0   # prompt tokens mapped instead of prefilled
    cow_copies: int = 0             # copy-on-write page copies performed
    n_preempted: int = 0            # terminal preemptions (budget exhausted)
    n_rejected: int = 0             # terminal rejections (any reason)
    reject_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    deadline_misses: int = 0        # deadline requests rejected or late
    n_stragglers: int = 0           # watchdog-flagged slow steps
    n_prefix_drops: int = 0         # fault-injected prefix-index drops
    n_prefix_drop_skips: int = 0    # prefix-drop faults skipped (no index)
    # Speculative-decoding token accounting (kind='verify' records).  A
    # verify step *drafts* spec_k - 1 tokens per active slot, *accepts* the
    # matched prefix of them, and *emits* accepted + 1 bonus tokens into
    # request outputs (minus any dropped past a request's max_new).  Only
    # emitted tokens ever enter ``Request.generated`` — so ``replay_cost``
    # (and thus ``replay_budget`` charging) counts accepted work only,
    # never the drafts the verifier rejected.
    n_drafted: int = 0              # draft tokens proposed to the verifier
    n_accepted: int = 0             # draft tokens the verifier accepted
    n_emitted: int = 0              # tokens appended to request outputs

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verifier accepted."""
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0

    #: Decode-side record kinds: plain fused decode and speculative verify
    #: launches both stream the same per-step KV state, so the serving
    #: BASE/PACK aggregates fold them together.
    _DECODE_KINDS = ("decode", "verify")

    @property
    def decode_steps(self) -> int:
        return sum(1 for r in self.records if r.kind in self._DECODE_KINDS)

    @property
    def spec_steps(self) -> int:
        return sum(1 for r in self.records if r.kind == "verify")

    @property
    def tokens(self) -> int:
        return sum(r.new_tokens for r in self.records)

    def _sum(self, attr: str, kind=("decode", "verify")) -> int:
        kinds = (kind,) if isinstance(kind, str) else kind
        return sum(
            getattr(r.traffic, attr)
            for r in self.records
            if r.kind in kinds and r.traffic is not None
        )

    @property
    def base_bytes(self) -> int:
        return self._sum("base_bytes")

    @property
    def pack_bytes(self) -> int:
        return self._sum("pack_bytes") + self._sum("index_bus_bytes_pack")

    @property
    def useful_bytes(self) -> int:
        return self._sum("useful_bytes")

    @property
    def base_efficiency(self) -> float:
        return self.useful_bytes / self.base_bytes if self.base_bytes else 1.0

    @property
    def pack_efficiency(self) -> float:
        return self.useful_bytes / self.pack_bytes if self.pack_bytes else 1.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0

    # -- prefill-side aggregates (same Traffic records, kind='prefill') ------

    @property
    def prefill_steps(self) -> int:
        return sum(1 for r in self.records if r.kind == "prefill")

    @property
    def prefill_base_bytes(self) -> int:
        return self._sum("base_bytes", "prefill")

    @property
    def prefill_pack_bytes(self) -> int:
        return (self._sum("pack_bytes", "prefill")
                + self._sum("index_bus_bytes_pack", "prefill"))

    @property
    def prefill_useful_bytes(self) -> int:
        return self._sum("useful_bytes", "prefill")

    @property
    def prefill_base_efficiency(self) -> float:
        b = self.prefill_base_bytes
        return self.prefill_useful_bytes / b if b else 1.0

    @property
    def prefill_pack_efficiency(self) -> float:
        p = self.prefill_pack_bytes
        return self.prefill_useful_bytes / p if p else 1.0

    # -- prefix-sharing aggregates (kind='share' records) --------------------

    @property
    def shared_pages(self) -> int:
        """Physical pages mapped by refcount bump instead of prefilled."""
        return sum(
            r.traffic.shared_pages
            for r in self.records
            if r.traffic is not None
        )

    @property
    def share_events(self) -> int:
        return sum(1 for r in self.records if r.kind == "share")

    @property
    def shared_useful_bytes(self) -> int:
        return self._sum("useful_bytes", "share")

    @property
    def shared_index_bytes(self) -> int:
        return self._sum("index_bus_bytes_pack", "share")

    @property
    def prefill_effective_pack_efficiency(self) -> float:
        """Prefill-side PACK efficiency with dedup folded in.

        Bytes of prompt KV the pool ends up serving (prefilled + shared)
        over the bytes PACK actually moved to get there (prefill payload
        and table fetches, plus the share remaps' table fetches).  Exceeds
        :attr:`prefill_pack_efficiency` exactly when prefix sharing elided
        prefill work — the dedup-before-packing multiplier; unlike a plain
        packing ratio it can exceed 1.
        """
        moved = (self.prefill_pack_bytes
                 + self._sum("pack_bytes", "share")
                 + self.shared_index_bytes)
        served = self.prefill_useful_bytes + self.shared_useful_bytes
        return served / moved if moved else 1.0


class Scheduler:
    """Continuous-batching scheduler driving one :class:`ServableFamily`.

    ``Scheduler(model, cache)`` binds the model to its resource pool via
    ``model.bind(cache)`` (every engine exposes it), so existing call
    sites keep working; an already-bound family can be passed directly as
    ``Scheduler(family)``.  The scheduler itself speaks only the protocol.
    """

    def __init__(self, model: Any, cache: Any = None, chunk: int = 8,
                 prefix_sharing: bool = False,
                 faults: Optional[FaultPlan] = None,
                 watchdog: Optional[Any] = None):
        if cache is not None:
            # May raise (e.g. the paged family's kv_dtype agreement check)
            # — binding validates model/pool compatibility.
            family: ServableFamily = model.bind(cache)
        elif isinstance(model, ServableFamily):
            family = model
        else:
            raise TypeError(
                "Scheduler needs a ServableFamily, or a model plus the "
                "cache/pool to bind one"
            )
        if prefix_sharing and not family.supports_prefix_sharing:
            raise ValueError("prefix_sharing requires a refcounted cache")
        self.family = family
        #: The family's underlying model (compat accessor; never used by
        #: scheduling logic).
        self.model = getattr(family, "model", model)
        self.chunk = chunk
        self.prefix_index: Optional[PrefixIndex] = (
            PrefixIndex(family.page_size) if prefix_sharing else None
        )
        #: Injected fault schedule (chaos testing); None = fault-free.
        self.faults = faults
        #: Anything with ``observe(dt, injected=...) -> bool`` — typically a
        #: :class:`repro.runtime.fault_tolerance.StragglerWatchdog`.
        self.watchdog = watchdog
        #: Priority/deadline-ordered wait queue (head = next to admit).
        self.queue: List[Request] = []
        self.resident: List[Request] = []      # admission order
        self.finished: Dict[int, Request] = {}
        self.preempted: Dict[int, Request] = {}  # terminal: budget exhausted
        self.rejected: Dict[int, Request] = {}   # terminal: never admitted
        self.stats = ServeStats()
        self._step = 0
        self._admit_counter = 0
        self._submit_counter = 0
        self._free_slots = list(range(family.batch))[::-1]

    @property
    def cache(self):
        """The family's underlying resource pool (page pool / state pool).

        Compatibility accessor for tests, benchmarks, and diagnostics; the
        scheduling logic itself never reaches through it.
        """
        return getattr(self.family, "cache", None)

    # -- public API ---------------------------------------------------------

    @staticmethod
    def _max_kv(request: Request) -> int:
        # The last generated token is never fed back, so KV peaks one short.
        return request.prompt_len + max(request.max_new - 1, 0)

    def _min_steps(self, request: Request) -> int:
        """Minimum scheduler steps from admission to completion: one per
        prefill chunk (the last emits the first token), plus one decode
        boundary when more tokens remain (fusion covers any length)."""
        prefill = -(-request.prompt_len // self.chunk)
        return prefill + (1 if request.max_new > 1 else 0)

    def _queue_key(self, r: Request) -> Tuple[int, float, int]:
        """Admission order: priority desc, deadline asc, submission order.

        An evicted request keeps its original ``_order``, so it re-enters
        ahead of later arrivals of equal priority — the behaviour the old
        FIFO ``appendleft`` re-queue had.
        """
        return (-r.priority, r.deadline_step, r._order)

    def _queue_push(self, r: Request) -> None:
        self.queue.append(r)
        self.queue.sort(key=self._queue_key)  # stable; queues are small

    def _reject(self, request: Request, reason: RejectReason, detail: str,
                strict: bool) -> bool:
        """Move ``request`` to the terminal REJECTED state (non-fatal)."""
        request.state = RequestState.REJECTED
        request.reject_reason = reason
        request.finish_step = self._step
        self.rejected[request.rid] = request
        self.stats.n_rejected += 1
        self.stats.reject_reasons[reason.value] = (
            self.stats.reject_reasons.get(reason.value, 0) + 1
        )
        if request.deadline_steps is not None:
            self.stats.deadline_misses += 1
        if strict:
            raise RequestRejected(request, reason, detail)
        return False

    def submit(self, request: Request, strict: bool = True) -> bool:
        """Queue a request, or reject it with a typed, non-fatal reason.

        Returns ``True`` when queued.  A request that can never be served
        (``NEVER_FITS``) or whose deadline is impossible even on an idle
        pool (``DEADLINE_INFEASIBLE``) goes straight to the terminal
        ``REJECTED`` state; with ``strict=True`` (default) a
        :class:`RequestRejected` is also raised so misuse is loud, with
        ``strict=False`` submit just returns ``False``.  Either way the
        scheduler remains fully consistent — rejection is bookkeeping, not
        a failure.
        """
        if request.max_new < 1:
            raise ValueError(
                f"request {request.rid}: max_new must be >= 1"
            )
        request.submit_step = self._step
        worst = self.family.units_for(self._max_kv(request))
        if worst > self.family.total_units:
            return self._reject(
                request, RejectReason.NEVER_FITS,
                f"needs up to {worst} pages; the pool holds "
                f"{self.family.total_units}", strict,
            )
        if self._max_kv(request) > self.family.slot_token_capacity:
            return self._reject(
                request, RejectReason.NEVER_FITS,
                f"prompt+generation ({self._max_kv(request)} tokens) exceeds "
                f"the {self.family.slot_token_capacity}-token slot capacity",
                strict,
            )
        if (request.deadline_steps is not None
                and request.deadline_steps < self._min_steps(request)):
            return self._reject(
                request, RejectReason.DEADLINE_INFEASIBLE,
                f"deadline of {request.deadline_steps} steps is below the "
                f"{self._min_steps(request)}-step minimum", strict,
            )
        request.state = RequestState.WAITING
        request._order = self._submit_counter
        self._submit_counter += 1
        self._queue_push(request)
        return True

    def _stall_report(self, max_steps: int) -> str:
        """Diagnostic dump for SchedulerStalledError: names every stuck
        request with enough state to see *why* it is stuck."""
        lens = self._lengths()
        lines = [
            f"scheduler stalled after {max_steps} steps: "
            f"{len(self.queue)} queued, {len(self.resident)} resident, "
            f"{self.family.free_units}/{self.family.total_units} pages free, "
            f"{len(self._free_slots)} slots free",
        ]
        for r in list(self.resident) + list(self.queue):
            kv = int(lens[r.slot]) if r.slot >= 0 else 0
            lines.append(
                f"  request {r.rid}: state={r.state.value} slot={r.slot} "
                f"prefill_pos={r.prefill_pos}/{r.prompt_len} "
                f"generated={len(r.generated)}/{r.max_new} kv_len={kv} "
                f"priority={r.priority} evictions={r.n_evictions}"
            )
        return "\n".join(lines)

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive all submitted requests to a terminal state.

        Returns the completed outputs (``finished`` only); preempted and
        rejected requests are tracked in :attr:`preempted` /
        :attr:`rejected` with their partial state.  Raises
        :class:`SchedulerStalledError` — with a full per-request dump —
        if work is still pending after ``max_steps``.
        """
        t0 = time.perf_counter()
        while (self.queue or self.resident) and self._step < max_steps:
            self.step()
        self.stats.wall_s += time.perf_counter() - t0
        if self.queue or self.resident:
            raise SchedulerStalledError(self._stall_report(max_steps))
        return {rid: r.generated for rid, r in sorted(self.finished.items())}

    def step(self) -> None:
        """One scheduler iteration: expire deadlines → admit → one batched
        prefill chunk → fused decode to the next scheduling boundary →
        retire.  Injected faults (``self.faults``) apply for the duration
        of the step; its wall time (plus any injected latency) feeds the
        watchdog."""
        self._step += 1
        t0 = time.perf_counter()
        if self.faults is not None and self.faults.drop_prefix(self._step):
            if self.prefix_index is None:
                # The fault action doesn't apply to this family/config (no
                # prefix index to drop): counted no-op, never a raise.
                self.stats.n_prefix_drop_skips += 1
            else:
                self._drop_prefix_fault()
        self._expire_deadlines()
        self._admit()
        self._prefill_all()
        self._decode()
        self._retire()
        if self.watchdog is not None:
            injected = (self.faults.delay(self._step)
                        if self.faults is not None else 0.0)
            if self.watchdog.observe(time.perf_counter() - t0,
                                     injected=injected):
                self.stats.n_stragglers += 1

    # -- fault hooks ---------------------------------------------------------

    def _effective_free(self) -> int:
        """Free units as scheduling policy sees them: zero while a forced
        pool-exhaustion fault is active (the physical free list is
        untouched — CoW and already-checked admissions still succeed)."""
        if self.faults is not None and self.faults.exhaust(self._step):
            return 0
        return self.family.free_units

    def _alloc_denied(self) -> bool:
        return (self.faults is not None
                and self.faults.deny_alloc(self._step))

    def _drop_prefix_fault(self) -> None:
        """Fault: drop one seeded-random retained prefix chain.  Sharing is
        an optimization, so victims of the drop simply re-prefill — the
        chaos suite asserts outputs are unchanged."""
        entries = list(self.prefix_index.entries)
        if not entries:
            return
        rng = np.random.default_rng([self.faults.seed, self._step])
        key = entries[int(rng.integers(len(entries)))]
        pages = self.prefix_index.pop_chain(key)
        self.family.release_units(pages)
        self.stats.n_prefix_drops += 1

    def _expire_deadlines(self) -> None:
        """Reject queued requests whose deadline can no longer be met.

        Admitted even *this* step, a request finishes no earlier than
        ``_step + _min_steps - 1``; when that overshoots the deadline the
        request is rejected as POOL_BUSY rather than served late.  Resident
        requests are never killed by a deadline — they finish and count a
        deadline miss instead (killing mid-flight work would waste the
        units it already filled).
        """
        expired = [
            r for r in self.queue
            if r.deadline_steps is not None
            and self._step + self._min_steps(r) - 1 > r.deadline_step
        ]
        for r in expired:
            self.queue.remove(r)
            self._reject(
                r, RejectReason.POOL_BUSY,
                f"deadline at step {int(r.deadline_step)} can no longer be "
                f"met at step {self._step}", strict=False,
            )

    # -- host shadow state ---------------------------------------------------

    def _lengths(self) -> np.ndarray:
        """Per-slot token lengths (family host shadow; no device sync)."""
        return self.family.lengths()

    # -- admission ----------------------------------------------------------

    def _reclaim_lookahead(self, need: int) -> None:
        """Trim residents' unwritten lookahead units back to the free pool.

        Lookahead prealloc (see ``_grow_units``) may have mapped units for
        generations that have not happened yet; those units hold no state,
        so reclaiming them for an admission is loss-free — the residents
        simply fall back to on-demand growth.  Trims youngest-first, down
        to each request's written content (prompt units for a request
        still in prefill)."""
        for r in sorted(self.resident, key=lambda x: -x.admit_order):
            if self._effective_free() >= need:
                return
            if r.state is RequestState.PREFILL:
                floor = self.family.units_for(r.prompt_len)
            else:
                floor = self.family.units_for(int(self._lengths()[r.slot]))
            self.family.trim(r.slot, floor)

    def _drop_retained(self, need: int,
                       keep: FrozenSet[bytes] = frozenset()) -> None:
        """Release retained prefix entries (LRU-first) until ``need`` free.

        An entry whose page is still shared with a resident frees nothing
        when dropped, so it is skipped; ``keep`` protects the chain a
        pending admission has just matched.  Dropping an entry drops its
        whole extension chain (see :meth:`PrefixIndex.pop_chain`).
        """
        if self.prefix_index is None:
            return
        for key in list(self.prefix_index.entries):
            if self._effective_free() >= need:
                return
            if key not in self.prefix_index.entries or key in keep:
                continue  # already popped as part of an earlier chain
            page_id = self.prefix_index.entries[key]
            if self.family.unit_refcount(page_id) > 1:
                continue
            pages = self.prefix_index.pop_chain(key, keep=keep)
            self.family.release_units(pages)

    def flush_prefix_cache(self) -> None:
        """Drop every retained prefix entry; unshared pages return to free."""
        if self.prefix_index is None:
            return
        self.family.release_units(self.prefix_index.pop_all())

    def _defer_for_inflight_prefix(self, r: Request) -> bool:
        """Hold admission while a still-prefilling resident is building a
        longer shared prefix for ``r`` than the index already offers.

        Registration happens at prefill completion, so concurrent arrivals
        with a common system prompt would otherwise each prefill it
        privately; waiting one scheduling boundary converts the later ones
        into refcount bumps.  Terminates because prefill advances every
        pending resident each step: the sibling either completes (and
        registers at least the pages counted here) or is evicted (and the
        defer condition vanishes).
        """
        assert self.prefix_index is not None
        page = self.family.page_size
        pr = np.asarray(r.prompt, dtype=np.int64)
        have = self.prefix_index.match_len(r.prompt)
        for s in self.resident:
            if s.state is not RequestState.PREFILL:
                continue
            ps = np.asarray(s.prompt, dtype=np.int64)
            limit = min(len(pr), (s.prompt_len // page) * page) // page
            n = 0
            while (n < limit and np.array_equal(
                    pr[n * page:(n + 1) * page], ps[n * page:(n + 1) * page])):
                n += 1
            if n > have:
                return True
        return False

    def _admit(self) -> None:
        while self.queue and self._free_slots:
            r = self.queue[0]
            shared: List[int] = []
            if self.prefix_index is not None:
                if self._defer_for_inflight_prefix(r):
                    return
                shared = self.prefix_index.lookup(r.prompt)
            page = self.family.page_size
            shared_tokens = len(shared) * page
            # Admission always (re-)prefills at least the prompt's last
            # token, so completing prefill yields fresh last-token logits.
            # A fully page-aligned match therefore writes one token into
            # its final *shared* page — privatized eagerly below via
            # copy-on-write, with the extra unit counted in ``need`` so two
            # same-step admissions can't both claim the same free unit.
            tail_start = min(shared_tokens, r.prompt_len - 1)
            cow_extra = 1 if shared_tokens > tail_start else 0
            # Units for the whole prompt, plus one decode unit of headroom
            # when the first appended token will cross a unit boundary.
            need = (self.family.units_for(
                min(r.prompt_len + 1, self._max_kv(r))
            ) - len(shared) + cow_extra)
            if need > 0 and self._alloc_denied():
                return  # fault: allocations fail this step; retry next step
            if self._effective_free() < need:
                self._reclaim_lookahead(need)
            if self._effective_free() < need and self.prefix_index is not None:
                self._drop_retained(
                    need,
                    keep=self.prefix_index.prefix_keys(r.prompt, len(shared)),
                )
            if self._effective_free() < need:
                return
            self.queue.pop(0)
            r.slot = self._free_slots.pop()
            r.state = RequestState.PREFILL
            r.prefill_pos = tail_start
            r.fed = 0
            r.admit_order = self._admit_counter
            self._admit_counter += 1
            if shared:
                self.family.share(r.slot, shared)
            fresh = self.family.units_for(r.prompt_len) - len(shared)
            if fresh > 0:
                self.family.alloc_state(r.slot, fresh)
            if cow_extra:
                self.stats.cow_copies += self.family.ensure_writable(
                    r.slot, tail_start, tail_start
                )
            # Reset the slot to fresh-prefill state: a no-op for paged
            # families (new pages are empty), a state-row zero for
            # recurrent ones — the half of eviction-replay that lives in
            # device state rather than in the token bookkeeping.
            self.family.replay(r.slot)
            if shared:
                # Replay after eviction walks this same path: the lookup
                # re-derives the mappings, so re-admission reuses the pages
                # (bit-identical KV, int8 scales included) it had before.
                self.stats.prefill_tokens_saved += tail_start
                traffic, streams = self.family.share_account(
                    tail_start, shared
                )
                self.stats.records.append(StepRecord(
                    step=self._step, kind="share", n_active=1, new_tokens=0,
                    traffic=traffic, streams=streams,
                ))
            self.resident.append(r)

    # -- prefill ------------------------------------------------------------

    def _prefill_all(self) -> None:
        """One chunk for *every* pending request, in one batched call."""
        pending = [r for r in self.resident if r.state is RequestState.PREFILL]
        if not pending:
            return
        pending.sort(key=lambda x: x.admit_order)
        toks, counts, slots, starts = build_prefill_rows(
            [(r.prompt, r.prefill_pos, r.slot) for r in pending],
            self.chunk, self.family.batch,
        )
        if self.prefix_index is not None:
            # Defensive: admission privatizes the only shared page a prefill
            # can write (the page-aligned-match boundary), so this is a
            # refcount scan that never copies — unless an invariant broke,
            # in which case copy-on-write still keeps siblings isolated.
            for i, r in enumerate(pending):
                self.stats.cow_copies += self.family.ensure_writable(
                    r.slot, int(starts[i]), int(starts[i] + counts[i]) - 1
                )
        logits = self.family.prefill_batch(toks, counts, slots, starts)
        new_tokens = 0
        completed = []
        for i, r in enumerate(pending):
            r.prefill_pos += int(counts[i])
            if r.prefill_pos == r.prompt_len:
                r.state = RequestState.RUNNING
                r.fed = 0
                if not r.generated:  # fresh prefill; a replay already has it
                    completed.append((i, r))
                if self.prefix_index is not None:
                    # Register the full prompt pages (the partial last page,
                    # which decode will keep writing, is never indexed) and
                    # give the index its refcount owner on the new entries.
                    n_full = r.prompt_len // self.family.page_size
                    new_pages = self.prefix_index.register(
                        r.prompt, self.family.slot_unit_ids(r.slot)[:n_full]
                    )
                    self.family.retain_units(new_pages)
        if completed:
            lg = logits.cpu().numpy()  # host sync: admission boundary only
            for i, r in completed:
                tok = int(np.argmax(lg[i, : self.family.vocab]))
                r.generated.append(tok)
                new_tokens += 1
                if r.on_token:
                    r.on_token(r, tok)
        # Stream descriptors + traffic in the family's own dialect, from
        # the same host-shadow math its kernels resolve (as decode does).
        n = len(pending)
        traffic, streams = self.family.prefill_account(
            slots[:n], starts[:n], counts[:n]
        )
        self.stats.records.append(StepRecord(
            step=self._step, kind="prefill", n_active=n,
            new_tokens=new_tokens, traffic=traffic, streams=streams,
        ))

    # -- decode -------------------------------------------------------------

    def _fused_steps(self, running: List[Request]) -> int:
        """Decode steps until the next scheduling boundary.

        Between boundaries nothing the scheduler decides on can change: the
        running set is fixed (retirement is a boundary), unit mappings are
        fixed (growth is a boundary), and admission cannot unblock (slots
        and units free up only at boundaries).  While any resident is still
        prefilling we keep single steps so prefill stays interleaved.
        """
        if any(r.state is RequestState.PREFILL for r in self.resident):
            return 1
        k = self.family.spec_k
        lens = self._lengths()
        # With speculation each launch step consumes up to ``k`` feed
        # tokens and writes up to ``k`` KV entries, so both horizons are
        # divided by ``k``: ceil for completion (the in-graph capacity
        # clamp plus the host-side done-drop make a partial final step
        # safe), floor for growth (a step with under ``k`` tokens of
        # headroom still progresses — the clamp scores what fits).
        to_done = min(-(-(r.max_new - 1 - r.fed) // k) for r in running)
        to_growth = min(
            (self.family.token_capacity(r.slot) - int(lens[r.slot])) // k
            for r in running
        )
        return max(1, min(to_done, to_growth))

    def _decode(self) -> None:
        running = [
            r for r in self.resident
            if r.state is RequestState.RUNNING and not r.done
        ]
        if not running:
            return
        running = self._grow_units(running)
        if not running:
            return
        b = self.family.batch
        tokens = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for r in running:
            tokens[r.slot] = r.generated[r.fed]
            active[r.slot] = True

        # Fuse up to the boundary: device-resident scan chunks, one token
        # sync at the end (the scheduling boundary).
        k = self.family.spec_k
        n = self._fused_steps(running)
        if self.prefix_index is not None:
            # Defensive: decode appends land past the prompt, and shared
            # pages only ever cover full prompt pages, so this scan never
            # copies unless an invariant broke (see _prefill_all).
            lens_cow = self._lengths()
            for r in running:
                ln = int(lens_cow[r.slot])
                self.stats.cow_copies += self.family.ensure_writable(
                    r.slot, ln, ln + n * k - 1
                )
        if k > 1:
            self._decode_speculative(running, tokens, active, n)
            return
        # Per-step accounting snapshots come *before* the launch mutates the
        # family's host shadows — identical records to a step-at-a-time run.
        accounts = self.family.step_streams(active, n)
        out = self.family.decode_steps(tokens, active, n)

        for s in range(n):
            traffic, streams = accounts[s]
            new_tokens = 0
            for r in running:
                r.fed += 1
                if r.fed < len(r.generated):
                    continue  # replay after eviction: output already known
                tok = int(out[s, r.slot])
                r.generated.append(tok)
                new_tokens += 1
                if r.on_token:
                    r.on_token(r, tok)
            self.stats.records.append(StepRecord(
                step=self._step, kind="decode", n_active=len(running),
                new_tokens=new_tokens, traffic=traffic, streams=streams,
            ))

    def _decode_speculative(self, running: List[Request],
                            tokens: np.ndarray, active: np.ndarray,
                            n: int) -> None:
        """Speculative counterpart of the plain fused-decode tail.

        One ``verify_steps`` launch covers ``n`` draft→verify→accept
        iterations; the emitted tokens per (step, slot) are data-dependent,
        so traffic accounting runs *after* the launch from the pre-launch
        length shadow (``verify_account``), and the host consumption loop
        walks ``counts[s, slot]`` emissions instead of exactly one.  A
        request that completes mid-launch simply drops the surplus
        emissions (the device kept verifying its own greedy continuation;
        the extra KV dies with the slot at retirement).  Replay is the
        plain-decode story unchanged: emitted tokens are the greedy
        sequence, so re-fed requests consume recorded tokens until
        ``fed`` catches up with ``generated``.
        """
        k = self.family.spec_k
        lens0 = np.array(self._lengths(), copy=True)
        toks, counts = self.family.verify_steps(tokens, active, n)
        accounts = self.family.verify_account(lens0, active, counts)
        for s in range(n):
            traffic, streams = accounts[s]
            new_tokens = 0
            for r in running:
                c = int(counts[s, r.slot])
                self.stats.n_drafted += k - 1
                self.stats.n_accepted += max(c - 1, 0)
                for i in range(c):
                    if r.done:
                        break  # surplus emissions past max_new: dropped
                    r.fed += 1
                    if r.fed < len(r.generated):
                        continue  # replay after eviction: output known
                    tok = int(toks[s, r.slot, i])
                    r.generated.append(tok)
                    new_tokens += 1
                    self.stats.n_emitted += 1
                    if r.on_token:
                        r.on_token(r, tok)
            self.stats.records.append(StepRecord(
                step=self._step, kind="verify", n_active=len(running),
                new_tokens=new_tokens, traffic=traffic, streams=streams,
            ))

    def _grow_units(self, running: List[Request]) -> List[Request]:
        """Allocate a unit for every running request whose next token lands
        past its slot's capacity, evicting the cheapest low-priority resident
        when the pool runs dry (the requester itself defers when it *is* the
        victim).  Returns the requests that still run this step.  Families
        whose slots never grow (recurrent state) report unbounded capacity,
        so this is pure pass-through for them."""
        lengths = self._lengths()
        spec_k = self.family.spec_k
        deferred: set = set()
        for r in sorted(running, key=lambda x: x.admit_order):
            if r.state is not RequestState.RUNNING:
                continue  # evicted below by another request's allocation
            # Headroom this step needs: one token for plain decode, up to
            # ``spec_k`` for a speculative family (capped by the tokens the
            # request can still feed — the last verify step never needs
            # room past its final emission).  With spec_k == 1 this is
            # exactly the old ``lengths == capacity`` growth trigger.
            head = min(spec_k, max(r.max_new - 1 - r.fed, 1))
            target = int(lengths[r.slot]) + head
            while (r.state is RequestState.RUNNING
                   and self.family.token_capacity(r.slot) < target):
                if self._alloc_denied():
                    # Fault: allocations fail this step.  The request keeps
                    # its slot and units; with zero headroom it sits out
                    # this step's decode (growth retried next boundary),
                    # with partial headroom the capacity clamp lets it run
                    # short.  Nothing was mutated, so the pool stays
                    # consistent (the crash-consistency contract).
                    if (self.family.token_capacity(r.slot)
                            <= int(lengths[r.slot])):
                        deferred.add(r.rid)
                    break
                while (r.state is RequestState.RUNNING
                       and self._effective_free() < 1):
                    # Retained-but-unshared prefix pages are the cheapest
                    # relief (no resident loses work); then evict the
                    # lowest-priority resident with the cheapest replay
                    # (youngest on ties).  Each iteration frees a unit,
                    # removes a resident, or empties the index, so the loop
                    # terminates.
                    self._drop_retained(1)
                    if self._effective_free() >= 1:
                        break
                    victim = min(
                        self.resident,
                        key=lambda x: (
                            x.priority, x.replay_cost, -x.admit_order
                        ),
                    )
                    if victim is r and len(self.resident) == 1:
                        if (self.prefix_index is not None
                                and self.prefix_index.entries):
                            # Last resort: drop retention even for pages
                            # this request shares — it keeps its own
                            # mappings.
                            self.flush_prefix_cache()
                            continue
                        # Pool truly (or by injected fault) cannot grow the
                        # only resident: it defers by self-eviction —
                        # requeued for replay, or preempted when its budget
                        # is spent.  Never an exception out of run().
                        self._evict(r)
                        break
                    self._evict(victim)  # may be r: it defers, not others
                if r.state is not RequestState.RUNNING:
                    break
                if not self.family.grow(r.slot, 1):
                    if (self.family.token_capacity(r.slot)
                            <= int(lengths[r.slot])):
                        deferred.add(r.rid)
                    break
        still = [
            r for r in running
            if r.state is RequestState.RUNNING and r.rid not in deferred
        ]
        # Opportunistic lookahead: when nothing can be admitted or prefilled
        # before the next boundary AND the free pool covers *every* running
        # request's full remaining generation, map those units up front, so
        # growth stops being a scheduling boundary and decode fuses through.
        # The all-or-nothing condition means lookahead can never starve a
        # peer's imminent on-demand growth (no extra evictions versus the
        # on-demand policy); under pool pressure it simply stays off and
        # behaviour is exactly the on-demand path.
        if not self.queue and not self._alloc_denied() and not any(
            x.state is RequestState.PREFILL for x in self.resident
        ):
            lens = self._lengths()
            # Speculative families over-write by up to spec_k - 1 KV
            # entries past the final emission (the clamp would otherwise
            # shorten the last verify steps and reintroduce growth
            # boundaries), so lookahead maps that margin too — capped at
            # the slot's hard token capacity.
            wants = {
                r.rid: (self.family.units_for(min(
                    int(lens[r.slot]) + (r.max_new - 1 - r.fed)
                    + (spec_k - 1),
                    self.family.slot_token_capacity,
                )) - self.family.mapped_units(r.slot))
                for r in still
            }
            if sum(max(w, 0) for w in wants.values()) <= self._effective_free():
                for r in sorted(still, key=lambda x: x.admit_order):
                    if wants[r.rid] > 0:
                        self.family.alloc_state(r.slot, wants[r.rid])
        return still

    def _evict(self, r: Request) -> None:
        """Release ``r``'s units and slot, then requeue it for bit-identical
        replay — unless replaying it would blow its ``replay_budget``, in
        which case it lands in the terminal PREEMPTED state with its partial
        output intact."""
        cost = r.replay_cost  # before release: prompt + tokens to re-derive
        self.family.release(r.slot)
        self.resident.remove(r)
        self._free_slots.append(r.slot)
        r.slot = -1
        r.prefill_pos = 0
        r.fed = 0
        if (r.replay_budget is not None
                and r.replay_spent + cost > r.replay_budget):
            r.state = RequestState.PREEMPTED
            r.finish_step = self._step
            self.preempted[r.rid] = r
            self.stats.n_preempted += 1
            if r.deadline_steps is not None:
                self.stats.deadline_misses += 1
            return
        r.replay_spent += cost
        r.state = RequestState.WAITING
        r.n_evictions += 1
        self.stats.n_evictions += 1
        # Keeps its original submission order, so among equal priorities it
        # re-admits first — the FIFO fairness the old appendleft gave.
        self._queue_push(r)

    # -- retirement ---------------------------------------------------------

    def _retire(self) -> None:
        for r in [x for x in self.resident if x.done]:
            self.family.release(r.slot)
            self.resident.remove(r)
            self._free_slots.append(r.slot)
            r.slot = -1
            r.state = RequestState.FINISHED
            r.finish_step = self._step
            if (r.deadline_steps is not None
                    and r.finish_step > r.deadline_step):
                self.stats.deadline_misses += 1
            self.finished[r.rid] = r
            if r.on_finish:
                r.on_finish(r)
