"""Host-side accounting of the port: stream descriptors and bus traffic."""
from .packing import (
    Traffic,
    packed_token_bytes,
    paged_decode_traffic,
    paged_prefill_traffic,
    prefill_page_counts,
    prefix_share_traffic,
    recurrent_decode_traffic,
    recurrent_prefill_traffic,
    spec_verify_traffic,
)
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
)
