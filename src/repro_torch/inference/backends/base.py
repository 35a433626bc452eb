"""Execution-backend protocol: what the scheduler needs from a device path.

Copy of ``repro/inference/backends/base.py``; ``CallAccount`` gains
``kernel_launches``, the launches of the port's hand-written kernels in one
call, read from the wrappers' counts.

The scheduler layer (``repro_torch.inference.engine.ServeEngine``) owns request
lifecycle — slots, admission, chunked prefill, preemption/offload policy,
block tables — and is deliberately device-free: no meshes, no shard_map,
no placement.  Everything that touches devices lives behind this protocol:

  * cache construction (where the KV pytree lives, and how it is sharded)
  * the four step kinds (contiguous prefill/decode, paged chunk/decode)
  * plan/fusion dispatch (the launch-plan runtime) and its accounting

Each call returns ``(logits, cache)`` exactly like the jitted closures the
monolithic engine used, plus fills ``backend.last`` with a ``CallAccount``
the scheduler folds into ``EngineStats`` — one merge path for jit, planned,
and sharded execution instead of three inline copies.

The port has ``LocalBackend`` (one device: CUDA graphs under ``plan="jit"``,
eager PyTorch under ``plan="eager"``); the sharded and speculative
backends are still to port (ROADMAP Queue A).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable


@dataclass
class CallAccount:
    """Dispatch/collective accounting for ONE backend call.

    ``dispatches`` counts host launch events summed over per-device
    dispatch streams (a tp=4 jit step is 1 executable but 4 streams), so
    ``EngineStats.decode_dispatches`` keeps the paper's per-device launch
    semantics as tensor parallelism grows.
    """
    dispatches: int = 0             # host launches, summed over device streams
    host_time_s: float = 0.0        # measured host dispatch time of this call
    modeled_tklqt_s: float = 0.0    # modeled TKLQT (planned modes; 0 for jit)
    rule_names: tuple = ()          # fusion rules that fired (planned modes)
    segment_names: tuple = ()       # per-segment labels (telemetry spans)
    segment_host_times: tuple = ()  # measured per-segment host dispatch
    collectives: int = 0            # collective ops issued (psum count)
    collective_bytes: int = 0       # payload bytes entering collectives
    modeled_collective_tax_s: float = 0.0  # priced over the platform link
    # --- speculative decoding (SpeculativeBackend; zero everywhere else)
    proposed: int = 0               # draft tokens offered to this verify
    accepted: int = 0               # draft tokens that matched target argmax
    draft_dispatches: int = 0       # launches on the draft's dispatch stream
    modeled_draft_launch_tax_s: float = 0.0  # draft stream priced per platform
    # --- operator->kernel attribution (planned modes; None/() for jit)
    segment_ops: tuple = ()         # per-segment {op -> kernel count} maps
    attribution: object = None      # telemetry AttributionReport for ONE call
    # --- hand-written kernels (port): wrapper name -> launches in the call
    kernel_launches: dict = field(default_factory=dict)


@dataclass
class BackendInfo:
    """Static facts the scheduler surfaces in stats/reports."""
    kind: str                       # "local" | "sharded" | ...
    tp: int = 1                     # tensor-parallel degree (device streams)
    devices: tuple = ()             # device ids backing this backend


@runtime_checkable
class ExecutionBackend(Protocol):
    """Device-side half of the serving engine.

    All methods are functional over the cache pytree: take it, return the
    updated one.  ``last`` holds the accounting of the most recent call.
    """

    info: BackendInfo
    last: CallAccount

    # ------------------------------------------------------------ caches
    def init_contiguous_cache(self):
        """Fresh per-slot KV cache pytree, placed for this backend."""
        ...

    def init_paged_cache(self, kv):
        """Fresh pages pytree for a ``PagedKVCache`` geometry, placed."""
        ...

    # ------------------------------------------------------------ steps
    def prefill(self, cache, tokens, slot: int, plen: int):
        """Contiguous prefill of one slot; tokens (1, bucket) padded."""
        ...

    def decode(self, cache, tokens, lengths):
        """One batched contiguous decode step; tokens (B, 1)."""
        ...

    def prefill_chunk(self, cache, tokens, bt_row, t0):
        """One paged prefill chunk; tokens (1, C), bt_row (NB,)."""
        ...

    def paged_decode(self, cache, tokens, lengths, block_tables):
        """One batched paged decode step."""
        ...

    def verify(self, cache, tokens, lengths):
        """Batched multi-token verify; tokens (B, k+1), ALL logits back."""
        ...

    def paged_verify(self, cache, tokens, lengths, block_tables):
        """Same over the paged cache."""
        ...

    # ------------------------------------------------------- accounting
    @property
    def device_dispatches(self) -> dict:
        """Cumulative launches per device stream (device index -> count)."""
        ...

    @property
    def planned_decode(self) -> Optional[object]:
        """The decode ``_PlannedFn`` when a launch-plan mode is active
        (telemetry exports its modeled device events); None otherwise."""
        ...


class AccountingMixin:
    """Shared per-device dispatch bookkeeping for concrete backends.

    Concrete ``__init__`` must set ``self.info`` and call
    ``self._init_accounting()``.
    """

    def _init_accounting(self) -> None:
        """Zero the per-call account and per-device dispatch map."""
        self.last = CallAccount()
        self._device_dispatches: dict = {}
        self._m_calls = None
        self._m_dispatches = None
        self._m_host = None
        self._m_coll_bytes = None

    def bind_metrics(self, registry) -> None:
        """Publish per-call accounting into a ``MetricsRegistry``; idempotent
        (families are get-or-create) and cheap per call (counter adds)."""
        kind = self.info.kind
        self._m_calls = registry.counter(
            "backend_calls_total", "backend step calls",
            labels=("backend",))
        self._m_dispatches = registry.counter(
            "backend_dispatches_total",
            "host launches summed over device streams", labels=("backend",))
        self._m_host = registry.counter(
            "backend_host_seconds_total",
            "measured host dispatch time", labels=("backend",))
        self._m_coll_bytes = registry.counter(
            "backend_collective_bytes_total",
            "payload bytes entering collectives", labels=("backend",))
        self._m_kind = kind

    def _charge(self, acct: CallAccount) -> CallAccount:
        """Record ``acct`` as the last call and fold per-device counts."""
        self.last = acct
        per_dev = acct.dispatches // max(self.info.tp, 1)
        for d in range(self.info.tp):
            key = self.info.devices[d] if d < len(self.info.devices) else d
            self._device_dispatches[key] = (
                self._device_dispatches.get(key, 0) + per_dev)
        if self._m_calls is not None:
            self._m_calls.inc(backend=self._m_kind)
            self._m_dispatches.inc(acct.dispatches, backend=self._m_kind)
            self._m_host.inc(acct.host_time_s, backend=self._m_kind)
            if acct.collective_bytes:
                self._m_coll_bytes.inc(acct.collective_bytes,
                                       backend=self._m_kind)
        return acct

    @property
    def device_dispatches(self) -> dict:
        """Cumulative host dispatches per device stream."""
        return dict(self._device_dispatches)
