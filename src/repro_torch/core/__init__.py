"""Host-side accounting of the port: stream descriptors and bus traffic."""
from .packing import (
    Traffic,
    packed_token_bytes,
    paged_decode_traffic,
    paged_prefill_traffic,
    prefill_page_counts,
    prefix_share_traffic,
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
    share_table_streams,
)
