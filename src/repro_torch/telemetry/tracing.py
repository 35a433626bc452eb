"""Request-scoped distributed tracing: typed lifecycle events per request.

A ``RequestTracer`` is minted once per serving run and threaded through
every layer a request crosses — router ingress, policy dispatch, engine
admission, (chunked) prefill, batched decode steps, preemption /
offload / restore, completion — each of which stamps a typed
``TraceEvent`` on the virtual clocks the serving tier already keeps
(engine ``now`` / router ``clock``).  The tracer is deliberately dumb:
recording is one small-object append per event, a ``None`` tracer costs
one attribute check at every hook, and nothing is aggregated until
``repro_torch.telemetry.critical_path.analyze`` walks the per-request
timelines.

Events are request-scoped, not step-scoped: a batched decode step that
served four slots appends one event to each of the four request traces
(per-request latency decomposition charges the full step duration to
every participant — each of them was waiting on that step).  The same
tracer instance is shared across all replicas of a fleet, so one trace
follows a request across dispatch, re-queue, and re-dispatch.

Event kinds (``EVENT_KINDS``):

  ingress       request released into the serving tier (t = arrival)
  dispatch      router picked a replica (meta: ``replica``)
  admit         engine bound the request to a slot (meta: ``resume``,
                ``restore_bytes``/``restore_tax_s`` when KV came back
                from the host offload tier)
  prefill       one (chunked) prefill interval (meta: ``tax_s`` measured
                launch tax, ``replay`` for preemption recompute)
  decode        one batched decode/verify interval the request took part
                in (meta: ``tax_s``, ``batch``, ``modeled_tklqt_s``)
  first_token   first emission (TTFT anchor)
  preempt       evicted from its slot (meta: ``mode``,
                ``offload_bytes``/``offload_tax_s`` when KV was staged)
  done          final token emitted (meta: ``n_tokens``)
  reject        admission refused (prompt + budget > max_len)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

EVENT_KINDS = ("ingress", "dispatch", "admit", "prefill", "decode",
               "first_token", "preempt", "done", "reject")

# sort tiebreak for events sharing a timestamp: lifecycle order, so a
# preempt and the re-admit that follows at the same clock value replay
# in the order they actually happened
_KIND_ORDER = {k: i for i, k in enumerate(EVENT_KINDS)}


@dataclass
class TraceEvent:
    """One typed lifecycle event on a request's timeline.

    Point events have ``t1 == t0``; ``prefill``/``decode`` are intervals.
    ``meta`` carries kind-specific payload (see module docstring).
    """

    kind: str
    t0: float
    t1: float
    meta: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        """Interval length in seconds (0 for point events)."""
        return self.t1 - self.t0


@dataclass
class RequestTrace:
    """The full event timeline of one request."""

    rid: int
    arrival_s: float
    events: list = field(default_factory=list)

    def first(self, kind: str) -> Optional[TraceEvent]:
        """Earliest event of ``kind`` (None when absent)."""
        best = None
        for ev in self.events:
            if ev.kind == kind and (best is None or ev.t0 < best.t0):
                best = ev
        return best

    def last(self, kind: str) -> Optional[TraceEvent]:
        """Latest event of ``kind`` (None when absent)."""
        best = None
        for ev in self.events:
            if ev.kind == kind and (best is None or ev.t0 >= best.t0):
                best = ev
        return best

    def count(self, kind: str) -> int:
        """Number of events of ``kind``."""
        return sum(1 for ev in self.events if ev.kind == kind)

    def sorted_events(self) -> list:
        """Events in timeline order (kind order breaks timestamp ties)."""
        return sorted(self.events,
                      key=lambda e: (e.t0, _KIND_ORDER.get(e.kind, 99)))


class RequestTracer:
    """Collects ``RequestTrace``s across router, fleet, and engines.

    One instance per serving run; every layer that sees the request
    stamps events through the typed helpers below.  ``ingress`` is
    idempotent (first call wins) so a router-fed replica's ``submit``
    never doubles the mint.  Disabled hooks are a single ``is None``
    check at each call site — the tracer itself is never consulted when
    tracing is off.
    """

    def __init__(self):
        self.traces: dict[int, RequestTrace] = {}

    # ------------------------------------------------------------ mint
    def ingress(self, rid: int, t: float) -> RequestTrace:
        """Mint (or return) the trace for ``rid``; first call wins."""
        tr = self.traces.get(rid)
        if tr is None:
            tr = self.traces[rid] = RequestTrace(rid=rid, arrival_s=t)
            tr.events.append(TraceEvent("ingress", t, t))
        return tr

    def _event(self, rid: int, kind: str, t0: float, t1: float,
               **meta) -> None:
        """Append one event, minting the trace if the layer that should
        have (router/submit) was bypassed (direct ``admit`` calls)."""
        tr = self.traces.get(rid)
        if tr is None:
            tr = self.ingress(rid, t0)
        tr.events.append(TraceEvent(kind, t0, t1, meta))

    # ------------------------------------------------------------ router
    def dispatch(self, rid: int, t: float, *, replica: int) -> None:
        """Router routed ``rid`` to ``replica`` at router clock ``t``."""
        self._event(rid, "dispatch", t, t, replica=replica)

    # ------------------------------------------------------------ engine
    def admit(self, rid: int, t: float, *, resume: bool = False,
              restore_bytes: int = 0, restore_tax_s: float = 0.0) -> None:
        """Engine bound ``rid`` to a slot (``resume`` = re-admission)."""
        self._event(rid, "admit", t, t, resume=resume,
                    restore_bytes=restore_bytes,
                    restore_tax_s=restore_tax_s)

    def reject(self, rid: int, t: float) -> None:
        """Admission refused: prompt + budget exceed the KV region."""
        self._event(rid, "reject", t, t)

    def prefill(self, rid: int, t0: float, t1: float, *,
                tax_s: float = 0.0, replay: bool = False,
                chunk: int = 0) -> None:
        """One (chunked) prefill interval executed for ``rid``."""
        self._event(rid, "prefill", t0, t1, tax_s=tax_s, replay=replay,
                    chunk=chunk)

    def decode(self, rids, t0: float, t1: float, *, tax_s: float = 0.0,
               batch: int = 0, modeled_tklqt_s: float = 0.0) -> None:
        """One batched decode/verify interval; charged to every
        participating request (each was waiting on this very step)."""
        for rid in rids:
            self._event(rid, "decode", t0, t1, tax_s=tax_s, batch=batch,
                        modeled_tklqt_s=modeled_tklqt_s)

    def first_token(self, rid: int, t: float) -> None:
        """First emission for ``rid`` (the TTFT anchor)."""
        self._event(rid, "first_token", t, t)

    def preempt(self, rid: int, t: float, *, mode: str = "recompute",
                offload_bytes: int = 0, offload_tax_s: float = 0.0) -> None:
        """``rid`` evicted from its slot under pool pressure."""
        self._event(rid, "preempt", t, t, mode=mode,
                    offload_bytes=offload_bytes,
                    offload_tax_s=offload_tax_s)

    def done(self, rid: int, t: float, *, n_tokens: int = 0) -> None:
        """``rid`` emitted its final token."""
        self._event(rid, "done", t, t, n_tokens=n_tokens)

    # ------------------------------------------------------------ queries
    def __len__(self) -> int:
        return len(self.traces)

    def completed(self) -> list:
        """Traces that reached ``done``, in rid order."""
        return [tr for _, tr in sorted(self.traces.items())
                if tr.first("done") is not None]

    def clear(self) -> None:
        """Drop every trace (fresh measured run after a warmup)."""
        self.traces.clear()
