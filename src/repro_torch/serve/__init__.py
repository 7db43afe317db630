"""Serving in the port: the paged transformer family, its KV pool, the
family protocol, the continuous-batching scheduler and the chaos layer.

``family``, ``faults`` and ``scheduler`` are host-side copies of the
reference's modules; ``kv`` holds the pools as device tensors updated in
place; ``paged_lm`` runs the model through the CUDA kernels.
"""
from .family import OutOfPages, ServableFamily
from .kv import PagedKVCache
from .paged_lm import (
    PagedFamily,
    PagedLM,
    params_from_numpy,
    static_batch_generate,
)
from .faults import (
    FaultPlan,
    InvariantViolation,
    check_scheduler_invariants,
    terminal_states,
)
from .scheduler import (
    TERMINAL_STATES,
    PrefixIndex,
    RejectReason,
    Request,
    RequestRejected,
    RequestState,
    Scheduler,
    SchedulerStalledError,
    ServeStats,
    StepRecord,
    build_prefill_rows,
)
