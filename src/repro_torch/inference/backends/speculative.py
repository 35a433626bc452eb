"""Speculative execution backend: draft-propose / batched-verify.

Counterpart of ``repro/inference/backends/speculative.py``.  Wraps a target
backend (``LocalBackend``, or a ``ShardedBackend``: kind
``"speculative+sharded"``, the draft local on rank 0's device) and adds a small draft model that proposes k
tokens autoregressively; the target then verifies all k+1 positions in ONE
batched step (``verify``/``paged_verify``).  Accept/reject lives in the
scheduler (``repro_torch.inference.speculative.greedy_accept``); this class
owns only the device half: the draft's cache and steps and the accounting
of its extra dispatch stream.

The draft runs through a ``LocalBackend`` of its own under ``plan="jit"``
with the draft config's step bodies (``bodies.make_step_bodies``) on a
contiguous (B, T) cache, whatever cache the target keeps: one CUDA graph a
draft-step width (2 for the catch-up step after a fully accepted window,
1 after it) and one a prefill bucket.  Its attention goes through the
hand-written decode kernels: ``decode_attention_mq`` at width 2,
``decode_attention`` at width 1.

Accounting is the paper tie-in: every draft call is a host launch that
buys nothing by itself — it only pays off by shrinking the number of
sequential target steps.  Draft launches are counted on their own stream
(``CallAccount.draft_dispatches``) and priced per platform via
``core.device_model.dispatch_fanout_s`` into
``modeled_draft_launch_tax_s``, so the LC-vs-CC launch-tax gap shows up
directly in the engine stats and the ``spec_sweep``.  The hand-written
kernel launches of a draft call ride on its account like any call's.
"""
from __future__ import annotations

import time

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device_model import PLATFORMS, dispatch_fanout_s
from repro_torch.inference.backends.base import BackendInfo, CallAccount
from repro_torch.inference.backends.local import GraphStats, LocalBackend


class SpeculativeBackend:
    """Draft-propose / batched-verify wrapper around a target backend."""

    def __init__(self, target, draft_cfg: ModelConfig,
                 draft_params, *, max_batch: int, max_len: int,
                 platform: str = "Intel+H100"):
        self.target = target
        self.cfg_draft = draft_cfg
        self.draft_params = draft_params
        self.B = max_batch
        self.T = max_len
        self.platform = platform
        self.spec = PLATFORMS[platform]
        self.draft = LocalBackend(draft_cfg, draft_params,
                                  max_batch=max_batch, max_len=max_len,
                                  plan="jit", device=target.device,
                                  platform=platform)
        self.info = BackendInfo(
            kind=f"speculative+{target.info.kind}", tp=target.info.tp,
            devices=target.info.devices)
        self.last = CallAccount()
        self._draft_device_dispatches = 0
        self._m_draft_calls = None
        self._m_draft_host = None

    # ------------------------------------------------------------ draft side
    def init_draft_cache(self):
        """Fresh contiguous KV cache for the draft model."""
        return self.draft.init_contiguous_cache()

    def bind_metrics(self, registry) -> None:
        """Target backend publishes its own families; the draft's extra
        dispatch stream gets its own counters."""
        self.target.bind_metrics(registry)
        self._m_draft_calls = registry.counter(
            "speculative_draft_dispatches_total",
            "launches on the draft model's dispatch stream")
        self._m_draft_host = registry.counter(
            "speculative_draft_host_seconds_total",
            "measured host time of draft forwards")

    def _charge_draft(self, n_calls: int, host_time: float) -> CallAccount:
        """Account draft calls as their own dispatch stream, priced at one
        stream's host cost (``dispatch_fanout_s`` at tp=1)."""
        self.last = CallAccount(
            draft_dispatches=n_calls, host_time_s=host_time,
            modeled_draft_launch_tax_s=n_calls * dispatch_fanout_s(
                self.spec, 1),
            kernel_launches=dict(self.draft.last.kernel_launches))
        self._draft_device_dispatches += n_calls
        if self._m_draft_calls is not None:
            self._m_draft_calls.inc(n_calls)
            self._m_draft_host.inc(host_time)
        return self.last

    def draft_prefill(self, draft_cache, tokens, slot: int, plen: int):
        """Prefill the draft cache with a slot's prompt."""
        t0 = time.perf_counter()
        logits, draft_cache = self.draft.prefill(draft_cache, tokens, slot,
                                                 plen)
        self._charge_draft(1, time.perf_counter() - t0)
        return logits, draft_cache

    def draft_step(self, draft_cache, tokens, positions, lengths):
        """One autoregressive draft proposal step."""
        t0 = time.perf_counter()
        logits, draft_cache = self.draft.draft_step(draft_cache, tokens,
                                                    positions, lengths)
        self._charge_draft(1, time.perf_counter() - t0)
        return logits, draft_cache

    # ---------------------------------------------------- delegated protocol
    @property
    def device(self):
        return self.target.device

    @property
    def plan(self) -> str:
        return self.target.plan

    @property
    def graph_stats(self) -> GraphStats:
        """The target's and the draft's graphs together."""
        t, d = self.target.graph_stats, self.draft.graph_stats
        return GraphStats(captured=t.captured + d.captured,
                          capture_s=t.capture_s + d.capture_s,
                          memory_bytes=t.memory_bytes + d.memory_bytes,
                          replays=t.replays + d.replays)

    @property
    def trace_stats(self):
        return self.target.trace_stats

    def init_contiguous_cache(self):
        """Delegate target-cache construction to the wrapped backend."""
        return self.target.init_contiguous_cache()

    def init_paged_cache(self, kv):
        """Delegate paged-cache construction to the wrapped backend."""
        return self.target.init_paged_cache(kv)

    def reset_cache(self, cache) -> None:
        """Zero the target's cache in place (delegated)."""
        self.target.reset_cache(cache)

    def close(self) -> None:
        """Release the target (a sharded one stops its ranks)."""
        self.target.close()

    def _delegate(self, out):
        """Forward a target-backend result, mirroring its account."""
        self.last = self.target.last
        return out

    def prefill(self, cache, tokens, slot: int, plen: int):
        """Target prefill (delegated)."""
        return self._delegate(self.target.prefill(cache, tokens, slot, plen))

    def decode(self, cache, tokens, lengths):
        """Target decode step (delegated)."""
        return self._delegate(self.target.decode(cache, tokens, lengths))

    def prefill_chunk(self, cache, tokens, bt_row, t0):
        """Target paged prompt-chunk write (delegated)."""
        return self._delegate(
            self.target.prefill_chunk(cache, tokens, bt_row, t0))

    def paged_decode(self, cache, tokens, lengths, block_tables):
        """Target paged decode step (delegated)."""
        return self._delegate(
            self.target.paged_decode(cache, tokens, lengths, block_tables))

    def verify(self, cache, tokens, lengths):
        """Target verify of k+1 speculative positions (delegated)."""
        return self._delegate(self.target.verify(cache, tokens, lengths))

    def paged_verify(self, cache, tokens, lengths, block_tables):
        """Target paged verify (delegated)."""
        return self._delegate(
            self.target.paged_verify(cache, tokens, lengths, block_tables))

    # ------------------------------------------------------- accounting
    @property
    def device_dispatches(self) -> dict:
        """Target per-device dispatches with draft launches merged onto
        the lead device's stream."""
        merged = dict(self.target.device_dispatches)
        if self._draft_device_dispatches:
            lead = self.target._stream_key(0)
            merged[lead] = (merged.get(lead, 0)
                            + self._draft_device_dispatches)
        return merged

    @property
    def planned_decode(self):
        """The wrapped backend's launch-plan decode handle."""
        return self.target.planned_decode
