"""Paged KV-cache subsystem: block-table allocation, pooled device pages,
and a pinned host-memory offload tier priced by the coupling fabric."""
from repro_torch.kvcache.allocator import BlockPool  # noqa: F401
from repro_torch.kvcache.offload import HostOffloadTier  # noqa: F401
from repro_torch.kvcache.paged import (  # noqa: F401
    HostPages, PagedKVCache, default_num_blocks,
)
