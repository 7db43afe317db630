"""Serving in the port: the paged transformer family (with speculative
decoding), the recurrent RWKV6 / Mamba families, their pools, the family
protocol, the continuous-batching scheduler and the chaos layer.

``family``, ``faults`` and ``scheduler`` are host-side copies of the
reference's modules; ``kv`` holds the page pools as device tensors updated
in place; ``paged_lm`` and ``recurrent_lm`` run the models through the CUDA
kernels; ``drafter`` proposes the speculative draft tokens.
"""
from .drafter import Drafter, NGramDrafter, TinyLMDrafter
from .family import OutOfPages, ServableFamily
from .kv import PagedKVCache
from .paged_lm import (
    PagedFamily,
    PagedLM,
    params_from_numpy,
    static_batch_generate,
)
from .recurrent_lm import (
    RecurrentFamily,
    RecurrentLM,
    RecurrentStatePool,
    recurrent_params_from_numpy,
    recurrent_reference_generate,
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
