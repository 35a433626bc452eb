"""Block-table paged KV allocation: fixed-size token pages from one pool.

Copy of ``repro/kvcache/allocator.py`` (framework-free); its metrics
families go through the port's ``telemetry/registry.py``.  The pool is
pure host-side bookkeeping: device pages live in the per-layer cache list
(``models.make_paged_cache``); this class only decides WHICH page ids a
sequence owns.  Allocation is deterministic (lowest free id first) so
seeded engine runs place blocks identically run-to-run, and freed ids
return to the pool sorted: the copy-on-free discipline (pages are
zero-filled by the cache layer before reuse) means a fresh allocation
never leaks a previous occupant's KV.

Blocks are reference-counted so prefix sharing can map several owners'
leading block-table entries onto ONE physical page: ``adopt`` raises a
block's refcount into a second owner's list, ``free``/``trim`` only
return a block to the free list when its last reference drops, and
``cow`` implements copy-on-write: before an owner writes into a block
it shares, the engine swaps in a fresh private block and copies the page
contents (copy-then-divergence).
"""
from __future__ import annotations

import numpy as np


class BlockPool:
    """Fixed-size token-block pool with per-owner block lists."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks))
        self._owned: dict = {}            # owner -> [block ids, logical order]
        self._refs: dict[int, int] = {}   # block id -> reference count
        self.cow_copies_total = 0         # cumulative copy-on-write events
        self.peak_shared_blocks = 0       # high-water mark of shared pages
        self.block_bytes = 0              # per-block KV bytes (set by cache)
        self._m_used = None
        self._m_util = None
        self._m_allocs = None
        self._m_frees = None
        self._m_shared = None
        self._m_cow = None
        self._m_saved = None

    def bind_metrics(self, registry) -> None:
        """Publish pool occupancy into a ``MetricsRegistry``: gauges track
        the live state, counters the cumulative block churn."""
        self._m_used = registry.gauge(
            "kvcache_blocks_used", "KV pages currently owned by sequences")
        self._m_util = registry.gauge(
            "kvcache_block_utilization", "used / total KV pages")
        self._m_allocs = registry.counter(
            "kvcache_blocks_allocated_total", "KV pages handed out")
        self._m_frees = registry.counter(
            "kvcache_blocks_freed_total", "KV pages returned to the pool")
        self._m_shared = registry.gauge(
            "kv_shared_blocks", "KV pages with more than one live owner")
        self._m_cow = registry.counter(
            "kv_cow_copies_total", "copy-on-write page divergences")
        self._m_saved = registry.gauge(
            "kv_bytes_saved", "KV bytes deduplicated by prefix sharing")
        self._m_cow.inc(self.cow_copies_total)
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        shared = self.shared_blocks
        if shared > self.peak_shared_blocks:
            self.peak_shared_blocks = shared
        if self._m_used is not None:
            self._m_used.set(self.used_blocks)
            self._m_util.set(self.utilization)
        if self._m_shared is not None:
            self._m_shared.set(shared)
            self._m_saved.set(self.bytes_saved)

    # ------------------------------------------------------------ queries
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    @property
    def shared_blocks(self) -> int:
        """Physical blocks currently referenced by more than one owner."""
        return sum(1 for r in self._refs.values() if r > 1)

    @property
    def extra_refs(self) -> int:
        """References beyond the first — each one is a whole block some
        owner did NOT have to allocate."""
        return sum(r - 1 for r in self._refs.values())

    @property
    def bytes_saved(self) -> int:
        """KV bytes deduplicated by sharing (``block_bytes`` is stamped by
        the cache layer once the pages pytree exists)."""
        return self.extra_refs * self.block_bytes

    def ref_count(self, bid: int) -> int:
        """Live references to block ``bid`` (0 when free)."""
        return self._refs.get(bid, 0)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` KV entries."""
        return -(-n_tokens // self.block_size)

    def owned(self, owner) -> list:
        return list(self._owned.get(owner, ()))

    def owners(self) -> list:
        return list(self._owned)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    # ------------------------------------------------------------ mutation
    def alloc(self, owner, n: int) -> list:
        """Append ``n`` blocks to ``owner``'s list; lowest free ids first."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > len(self._free):
            raise MemoryError(
                f"block pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.num_blocks}")
        ids = self._free[:n]
        del self._free[:n]
        self._owned.setdefault(owner, []).extend(ids)
        for bid in ids:
            self._refs[bid] = 1
        if self._m_allocs is not None and n:
            self._m_allocs.inc(n)
        self._refresh_gauges()
        return ids

    def adopt(self, owner, ids: list) -> list:
        """Map ``ids`` (another owner's live blocks, logical order) into
        ``owner``'s list WITHOUT allocating: each block's refcount rises
        and the physical page is shared until a ``cow`` diverges it.
        Returns the adopted ids."""
        for bid in ids:
            if self._refs.get(bid, 0) < 1:
                raise ValueError(f"cannot adopt free block {bid}")
        own = self._owned.setdefault(owner, [])
        for bid in ids:
            self._refs[bid] += 1
            own.append(bid)
        self._refresh_gauges()
        return list(ids)

    def cow(self, owner, index: int) -> tuple:
        """Copy-on-write: ``owner`` is about to write into the shared block
        at position ``index`` of its list — swap in a fresh private block
        and drop the shared reference.  Returns ``(old_id, new_id)`` so
        the cache layer copies the page contents before the write lands.
        Raises MemoryError when no free block exists (the engine's
        evict-or-preempt policy decides what to do then)."""
        ids = self._owned.get(owner)
        if not ids or index >= len(ids):
            raise ValueError(f"{owner!r} has no block at index {index}")
        old = ids[index]
        if self._refs.get(old, 0) < 2:
            raise ValueError(f"block {old} is not shared; cow is a no-op")
        if not self._free:
            raise MemoryError(
                f"block pool exhausted: cow needs 1 free block of "
                f"{self.num_blocks}")
        new = self._free.pop(0)
        self._refs[new] = 1
        self._refs[old] -= 1
        ids[index] = new
        self.cow_copies_total += 1
        if self._m_allocs is not None:
            self._m_allocs.inc(1)
        if self._m_cow is not None:
            self._m_cow.inc(1)
        self._refresh_gauges()
        return old, new

    def _drop_refs(self, ids: list) -> list:
        """Decrement refcounts; return the ids whose LAST reference dropped
        (only those return to the free list / get zeroed)."""
        physical = []
        for bid in ids:
            n = self._refs.get(bid, 0) - 1
            if n <= 0:
                self._refs.pop(bid, None)
                physical.append(bid)
            else:
                self._refs[bid] = n
        return physical

    def free(self, owner) -> list:
        """Release all of ``owner``'s blocks; blocks still referenced by a
        sharer survive untouched.  Returns the PHYSICALLY freed ids so the
        cache layer can zero those pages."""
        ids = self._owned.pop(owner, [])
        physical = self._drop_refs(ids)
        self._free = sorted(self._free + physical)
        if self._m_frees is not None and physical:
            self._m_frees.inc(len(physical))
        self._refresh_gauges()
        return physical

    def ensure(self, owner, n_tokens: int) -> list:
        """Grow ``owner`` to cover ``n_tokens`` entries; returns the newly
        allocated ids (empty when already covered).  Raises MemoryError
        when the pool cannot satisfy the growth — the engine's
        evict-or-preempt policy decides what to do then."""
        have = len(self._owned.get(owner, ()))
        need = self.blocks_for(n_tokens)
        if need <= have:
            return []
        return self.alloc(owner, need - have)

    def trim(self, owner, n_tokens: int) -> list:
        """Shrink ``owner`` to the blocks covering ``n_tokens`` entries,
        releasing the tail ids (speculative-decode rollback: blocks grown
        for a verify window whose draft tokens were rejected).  Returns
        the freed ids so the cache layer can zero those pages — same
        copy-on-free discipline as ``free``."""
        ids = self._owned.get(owner)
        keep = self.blocks_for(n_tokens)
        if not ids or len(ids) <= keep:
            return []
        dropped = ids[keep:]
        del ids[keep:]
        physical = self._drop_refs(dropped)
        self._free = sorted(self._free + physical)
        if self._m_frees is not None and physical:
            self._m_frees.inc(len(physical))
        self._refresh_gauges()
        return physical

    def table_row(self, owner, n_entries: int, sentinel: int) -> np.ndarray:
        """(n_entries,) int32 block-table row, padded with ``sentinel``
        (an out-of-range page id: gathers clamp, scatters drop)."""
        row = np.full(n_entries, sentinel, np.int32)
        ids = self._owned.get(owner, ())
        row[:len(ids)] = ids[:n_entries]
        return row
