"""Host-memory offload tier for cold KV blocks, priced per coupling fabric.

Counterpart of ``repro/kvcache/offload.py``, with the same byte and
transfer accounting and the same modeled tax: every transfer is priced
through ``core.device_model.offload_cost_s`` with the platform's
host<->device link (PCIe for LC parts, NVLink-C2C for CC parts).

Where the reference staged evicted pages in host arrays as a stand-in for
pinned memory, the port stages each eviction in one pinned CPU buffer when
the pool is on CUDA (``PagedKVCache.gather_host``), so each eviction and
each restore is ONE real DMA over the card's host link.  Beside the
modeled tax the tier records a CUDA event pair around each of those
copies, so ``measured_copy_s`` is their device time: the transfer, plus
the few microseconds the host takes to enqueue it when the stream is
idle.  A pair is folded into the running total once it has completed;
the serving loop never waits on one.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.device_model import PLATFORMS, offload_cost_s


class HostOffloadTier:
    """Staging store for evicted KV blocks + transfer-cost accounting."""

    def __init__(self, platform: str):
        self.spec = PLATFORMS[platform]
        self._store: dict = {}       # rid -> (HostPages, n_blocks)
        self._pending: list = []     # (start, end) events not yet completed
        self._copy_s = 0.0           # device time of the completed copies
        self.timed_copies = 0
        self.offload_bytes = 0
        self.restore_bytes = 0
        self.evictions = 0
        self.restores = 0
        self.modeled_tax_s = 0.0     # total transfer time over the link
        self._m_bytes = None
        self._m_moves = None
        self._m_tax = None

    def bind_metrics(self, registry) -> None:
        """Publish transfer accounting into a ``MetricsRegistry``; the
        ``direction`` label separates evictions from restores."""
        self._m_bytes = registry.counter(
            "kvcache_offload_bytes_total",
            "per-device bytes moved over the host link",
            labels=("direction",))
        self._m_moves = registry.counter(
            "kvcache_offload_transfers_total",
            "eviction/restore operations", labels=("direction",))
        self._m_tax = registry.counter(
            "kvcache_offload_modeled_tax_seconds_total",
            "modeled host-link transfer time")

    def _charge(self, direction: str, nbytes: int, tax: float) -> None:
        if self._m_bytes is not None:
            self._m_bytes.inc(nbytes, direction=direction)
            self._m_moves.inc(direction=direction)
            self._m_tax.inc(tax)

    @contextlib.contextmanager
    def copy_timer(self, device: torch.device):
        """Time the copy issued inside the block with CUDA events on the
        current stream (nothing is timed on the CPU)."""
        if device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._pending.append((start, end))
        self.timed_copies += 1
        self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Add the completed pairs (every pair when ``wait``) to the total;
        copies complete in stream order."""
        while self._pending:
            start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                break
            self._copy_s += start.elapsed_time(end) / 1e3
            self._pending.pop(0)

    @property
    def measured_copy_s(self) -> float:
        """Device time of every offload and restore copy so far (0 on the
        CPU); waits for the last timed copy to finish."""
        self._fold(wait=True)
        return self._copy_s

    def holds(self, rid) -> bool:
        return rid in self._store

    def stored_blocks(self, rid) -> int:
        return self._store[rid][1] if rid in self._store else 0

    def evict(self, rid, host, n_blocks: int) -> tuple:
        """Stage ``rid``'s gathered pages (``HostPages``) host-side; returns
        (bytes_moved, modeled_transfer_s).  One DMA per block is the
        transfer count the latency floor multiplies.  This is the single
        pricing site: callers surface the returned tax."""
        nbytes = host.nbytes
        tax = offload_cost_s(self.spec, nbytes, transfers=max(n_blocks, 1))
        self._store[rid] = (host, n_blocks)
        self.offload_bytes += nbytes
        self.evictions += 1
        self.modeled_tax_s += tax
        self._charge("evict", nbytes, tax)
        return nbytes, tax

    def restore(self, rid) -> tuple:
        """Pop ``rid``'s staged pages for scatter back to device; returns
        (host, n_blocks, bytes_moved, modeled_transfer_s)."""
        host, n_blocks = self._store.pop(rid)
        nbytes = host.nbytes
        tax = offload_cost_s(self.spec, nbytes, transfers=max(n_blocks, 1))
        self.restore_bytes += nbytes
        self.restores += 1
        self.modeled_tax_s += tax
        self._charge("restore", nbytes, tax)
        return host, n_blocks, nbytes, tax

    def drop(self, rid) -> None:
        """Forget a finished request's staged blocks (if any)."""
        self._store.pop(rid, None)

    def clear(self) -> None:
        self._store.clear()
        self._pending = []
        self._copy_s = 0.0
        self.timed_copies = 0
        self.offload_bytes = 0
        self.restore_bytes = 0
        self.evictions = 0
        self.restores = 0
        self.modeled_tax_s = 0.0
