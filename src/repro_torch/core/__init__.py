"""Host-side accounting of the port (numpy copy of ``repro.core``).

* :mod:`.streams` -- stream descriptors (the AXI-Pack request form).
* :mod:`.packing` -- pack/unpack semantics as tensor functions, and the
  traffic accounting of streams and serving steps.
* :mod:`.busmodel` -- analytical BASE/PACK/IDEAL cycle model.
* :mod:`.banksim` -- cycle-approximate banked endpoint simulator.

Exports the names ``repro.core`` exports, and the serving helpers the
port's scheduler uses.
"""
from .streams import (
    BurstKind,
    ContiguousStream,
    IndirectStream,
    StreamDescriptor,
    StridedStream,
    beats_for,
    elements_per_beat,
    page_table_streams,
    prefill_table_streams,
    recurrent_state_streams,
    share_table_streams,
    verify_table_streams,
    word_addresses,
)
from .packing import (
    Traffic,
    indirect_traffic,
    pack_indirect,
    pack_strided,
    packed_token_bytes,
    paged_decode_traffic,
    paged_prefill_traffic,
    prefill_page_counts,
    prefix_share_traffic,
    recurrent_decode_traffic,
    recurrent_prefill_traffic,
    spec_verify_traffic,
    strided_traffic,
    unpack_indirect,
    unpack_strided,
)
from .busmodel import (
    BusConfig,
    Iteration,
    System,
    WorkloadModel,
    indirect_utilization_ceiling,
    stream_cycles,
)
from .banksim import (
    BankConfig,
    SimResult,
    crossbar_area_kge,
    indirect_utilization,
    simulate_stream,
    strided_utilization,
)
