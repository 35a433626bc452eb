"""Low-overhead span recorder for host-side dispatch telemetry.

Copy of ``repro/telemetry/spans.py``.

A ``SpanRecorder`` collects completed spans — (name, category, thread,
begin, end, args) — from the serving engine and the plan executor.  It is
deliberately dumb and allocation-light: recording is an ``append`` of one
small object, a disabled recorder costs one attribute check, and nothing
is aggregated until a report or export asks for it.  Timestamps are
whatever clock the caller stamps with (the engine uses its virtual
serving clock so idle fast-forwards don't appear as giant gaps).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

# chrome-trace thread ids for the merged timeline
TID_HOST = 0          # engine-level host work (prefill/decode dispatch)
TID_SEGMENTS = 1      # per-segment launches inside PlanExecutor
TID_DEVICE = 2        # modeled device lane (simulated kernels)


@dataclass
class Span:
    name: str
    cat: str
    t0: float                     # seconds, caller's clock
    t1: float
    tid: int = TID_HOST
    args: Optional[dict] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass
class SpanRecorder:
    """``max_spans=None`` (the default) keeps every span — right for
    short characterize runs that export full traces.  Long serving runs
    pass a cap: the recorder then keeps only the NEWEST ``max_spans``
    spans (ring-buffer semantics) and counts evictions in ``dropped``,
    also published as the ``telemetry_spans_dropped_total`` counter when
    a registry is bound."""

    enabled: bool = True
    spans: list = field(default_factory=list)
    max_spans: Optional[int] = None
    dropped: int = 0

    def __post_init__(self):
        if self.max_spans is not None and self.max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {self.max_spans}")
        self._dropped_total = None

    def bind_metrics(self, registry) -> None:
        self._dropped_total = registry.counter(
            "telemetry_spans_dropped_total",
            "spans evicted from the SpanRecorder ring buffer")
        if self.dropped:
            self._dropped_total.inc(self.dropped)

    def add(self, name: str, cat: str, t0: float, t1: float, *,
            tid: int = TID_HOST, **args) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(name, cat, t0, t1, tid=tid,
                               args=args or None))
        if self.max_spans is not None and len(self.spans) > self.max_spans:
            # one add() can overflow by at most one span, so a single
            # pop-from-front keeps the newest max_spans entries
            self.spans.pop(0)
            self.dropped += 1
            if self._dropped_total is not None:
                self._dropped_total.inc()

    @contextmanager
    def span(self, name: str, cat: str = "host", *, tid: int = TID_HOST,
             **args):
        """Wall-clock convenience wrapper (perf_counter timestamps)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, cat, t0, time.perf_counter(), tid=tid, **args)

    def clear(self) -> None:
        self.spans.clear()

    # ------------------------------------------------------------ queries
    def by_cat(self, cat: str) -> list:
        return [s for s in self.spans if s.cat == cat]

    def total_s(self, cat: str) -> float:
        return sum(s.dur for s in self.by_cat(cat))
