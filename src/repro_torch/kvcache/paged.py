"""Paged KV cache: pool bookkeeping + page ops on the per-layer cache list.

Counterpart of ``repro/kvcache/paged.py``.  ``PagedKVCache`` owns the
geometry (block size, pool size, blocks per slot) and the ``BlockPool``
allocator; the device pages are the per-layer list of
``models.make_paged_cache`` (``[{"k_pages","v_pages"[,"k_scale",
"v_scale"]}] * L``, pages shaped (P, bs, HKV, hd)).

The reference's page ops take and return a stacked pytree functionally.
The port's ``zero_pages``, ``scatter_host`` and ``copy_pages`` update the
per-layer tensors IN PLACE (and return the same list, so the engine's
calls read as the reference's).  ``gather_host`` returns the pages of some
blocks as one ``HostPages`` byte buffer, so an eviction or a restore
crosses the host link as one copy.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.inference.kv_quant import KV_DTYPES
from repro_torch.kvcache.allocator import BlockPool
from repro_torch.models import make_paged_cache


_ALIGN = 16     # byte alignment of each leaf in a HostPages buffer


def _leaves(pages: list):
    """Every page tensor, layer-major and by sorted key within a layer
    (the reference's ``jax.tree.leaves`` order within a layer)."""
    for layer in pages:
        for key in sorted(layer):
            yield layer[key]


class HostPages:
    """Pages of some blocks staged host-side in one uint8 buffer ``buf``
    (pinned when the pool is on CUDA); ``layout`` holds each page leaf's
    (byte offset, dtype, shape) in it, in ``_leaves`` order.  Each leaf
    starts on a 16-byte boundary."""

    def __init__(self, buf: torch.Tensor, layout: list):
        self.buf = buf
        self.layout = layout

    @staticmethod
    def plan(leaves, n_blocks: int) -> tuple:
        """(layout, total bytes) for ``n_blocks`` blocks of ``leaves``."""
        layout, off = [], 0
        for leaf in leaves:
            shape = (n_blocks, *leaf.shape[1:])
            layout.append((off, leaf.dtype, shape))
            n = leaf.element_size() * int(np.prod(shape))
            off += -(-n // _ALIGN) * _ALIGN
        return layout, off

    @property
    def nbytes(self) -> int:
        """Bytes of page data (the padding between leaves not counted)."""
        return sum(dtype.itemsize * int(np.prod(shape))
                   for _, dtype, shape in self.layout)

    def leaves(self, buf: Optional[torch.Tensor] = None) -> list:
        """Each leaf as a view into ``buf`` (default: the host buffer, or
        a device copy of it laid out the same)."""
        buf = self.buf if buf is None else buf
        return [buf[off:off + dtype.itemsize * int(np.prod(shape))]
                .view(dtype).view(shape) for off, dtype, shape in self.layout]


class PagedKVCache:
    """Geometry + allocator for a block-table paged KV cache."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 max_len: int, dtype=None, kv_dtype: str = "bf16",
                 device="cuda"):
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        self.device = device
        # every block-table row spans the full max_len, so tables have one
        # shape as sequences grow
        self.nb_per_slot = -(-max_len // block_size)
        self.pool = BlockPool(num_blocks, block_size)
        self.dtype = dtype or cfg.cdtype

    # page id guaranteed out of range: writes drop it, reads clamp it
    @property
    def sentinel(self) -> int:
        return self.num_blocks

    def make_pages(self) -> list:
        """Fresh zeroed per-layer pages (quantized layout when
        ``kv_dtype="int8"``).  Stamps the pool with the per-block byte
        size so ``kv_bytes_saved`` prices shared blocks correctly."""
        pages = make_paged_cache(self.cfg, self.num_blocks, self.block_size,
                                 self.dtype, kv_dtype=self.kv_dtype,
                                 device=self.device)
        self.pool.block_bytes = self.block_bytes(pages, 1)
        return pages

    # ------------------------------------------------------------ tables
    def table_row(self, owner) -> np.ndarray:
        return self.pool.table_row(owner, self.nb_per_slot, self.sentinel)

    def block_tables(self, owners: list) -> np.ndarray:
        """(B, nb_per_slot) int32 table; ``None`` entries (inactive rows)
        become all-sentinel rows whose writes are dropped."""
        rows = [self.table_row(o) if o is not None
                else np.full(self.nb_per_slot, self.sentinel, np.int32)
                for o in owners]
        return np.stack(rows).astype(np.int32)

    # ------------------------------------------------------- in-place ops
    @staticmethod
    def _index(pages: list, ids) -> torch.Tensor:
        dev = pages[0]["k_pages"].device
        return torch.as_tensor(np.asarray(ids, np.int64), device=dev)

    def zero_pages(self, pages: list, ids: list) -> list:
        """Copy-on-free: zero-fill the freed pages before the pool hands
        them to the next owner (no cross-request KV leaks, and masked
        attention over stale entries stays exact-zero)."""
        if not ids:
            return pages
        idx = self._index(pages, ids)
        for leaf in _leaves(pages):
            leaf.index_fill_(0, idx, 0)
        return pages

    def gather_host(self, pages: list, ids: list, timer=None) -> HostPages:
        """Copy ``ids``' page contents device->host (the offload DMA).  On
        CUDA one index kernel per leaf packs them into one device staging
        buffer, and ONE copy moves it into a pinned host buffer on the
        current stream; ``timer`` (``HostOffloadTier.copy_timer``) wraps
        that copy alone.  On the CPU the staging buffer is the result."""
        idx = self._index(pages, ids)
        leaves = list(_leaves(pages))
        layout, total = HostPages.plan(leaves, len(ids))
        staging = torch.empty(total, dtype=torch.uint8, device=idx.device)
        for leaf, dst in zip(leaves, HostPages(staging, layout).leaves()):
            torch.index_select(leaf, 0, idx, out=dst)
        if idx.device.type != "cuda":
            return HostPages(staging, layout)
        host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        with timer or contextlib.nullcontext():
            host.copy_(staging, non_blocking=True)
        return HostPages(host, layout)

    def scatter_host(self, pages: list, ids: list, host: HostPages,
                     timer=None) -> list:
        """Copy staged pages host->device into freshly allocated pages
        ``ids`` (the restore): ONE copy of the buffer on the current
        stream (``timer`` wraps it), then one index kernel per leaf."""
        idx = self._index(pages, ids)
        buf = host.buf
        if idx.device.type == "cuda":
            with timer or contextlib.nullcontext():
                buf = buf.to(idx.device, non_blocking=True)
        for leaf, src in zip(_leaves(pages), host.leaves(buf)):
            leaf.index_copy_(0, idx, src)
        return pages

    def copy_pages(self, pages: list, src_id: int, dst_id: int) -> list:
        """Copy-on-write divergence: duplicate block ``src_id``'s page
        contents into freshly allocated block ``dst_id`` in every layer,
        so the subsequent write lands on a private copy."""
        for leaf in _leaves(pages):
            leaf[dst_id] = leaf[src_id]
        return pages

    @staticmethod
    def block_bytes(pages: list, n_blocks: int = 1) -> int:
        """Bytes of KV held by ``n_blocks`` pool blocks across all layers
        (the reference's sum over its superblock axis)."""
        return sum(leaf.element_size() * int(np.prod(leaf.shape[1:]))
                   for leaf in _leaves(pages)) * n_blocks

    def reset(self) -> None:
        block_bytes = self.pool.block_bytes
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.pool.block_bytes = block_bytes


def default_num_blocks(max_batch: int, max_len: int, block_size: int,
                       num_blocks: Optional[int] = None,
                       kv_dtype: str = "bf16",
                       hd: Optional[int] = None,
                       payload_bytes: int = 2) -> int:
    """Pool size: explicit, else sized by KV BYTES: enough bytes for every
    slot at full length in the native cache dtype (capacity-equivalent to
    the contiguous cache).  A quantized pool holds the SAME byte budget,
    so with ``kv_dtype="int8"`` (and ``hd`` given) the default grows by
    ``payload_bytes*hd / (hd+4)`` (~1.88x for bf16 at hd=64).
    ``payload_bytes`` is the native dtype's itemsize (2 for bf16)."""
    if num_blocks is not None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        return num_blocks
    base = max_batch * (-(-max_len // block_size))
    if kv_dtype == "bf16" or hd is None:
        return base
    ratio = (payload_bytes * hd) / (hd + 4)
    return int(base * ratio)
