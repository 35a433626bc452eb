"""Critical-path analysis: decompose each request's latency into blame.

``analyze`` walks every ``RequestTrace`` a ``RequestTracer`` collected
and partitions the request's measured end-to-end interval
``[arrival, done]`` into exhaustive, non-overlapping segments:

  router_queue_wait    arrival → router dispatch (fleet ingress queue)
  admission_wait       dispatch (or arrival, engine-only runs) → slot
  prefill_exec         measured (chunked) prefill compute on the clock
  decode_exec          measured decode/verify steps the request rode
  launch_tax           host dispatch time carved out of exec intervals
                       (the measured per-call launch tax)
  interleave_wait      admitted but idle between steps (other replicas'
                       turns, other requests' prefill chunks)
  preemption_stall     evicted, waiting to be re-admitted
  offload_restore_tax  modeled KV offload/restore transfer time carved
                       out of the enclosing preemption stall

The partition is exact *by construction*: the walk keeps a monotone
cursor from ``arrival`` to ``done``, charges every gap between events to
the wait bucket of the request's current lifecycle state, and clamps
event timestamps to the cursor (router and replica clocks can disagree
by a dispatch — clamping folds the skew into the neighbouring wait
instead of double-counting).  The **conservation invariant** — segments
sum to the measured E2E within float tolerance — is therefore a
structural guarantee the tests assert per request, the request-level
analogue of the attribution layer's rational 100%-of-dispatches sum.

Offload/restore transfer is *modeled* tax (it never advances the
engine's virtual clock), so it cannot be its own clock interval without
breaking conservation; instead ``min(modeled tax, stall window)`` is
carved out of the preemption stall it hides inside.

On top of the decomposition: per-scenario ``SLO`` thresholds, a
``slo_report`` classifying every completed request (goodput = fraction
meeting both TTFT and ITL), ``record_goodput`` publishing first-class
goodput/blame families into a metrics registry, and ``triage`` — the
JSON report ``--trace-out`` ships, with a per-request waterfall and an
aggregate + p99-tail blame table ("p99 TTFT violators: 71%
router_queue_wait").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.telemetry.metrics import percentile

SEGMENTS = ("router_queue_wait", "admission_wait", "prefill_exec",
            "launch_tax", "decode_exec", "interleave_wait",
            "preemption_stall", "offload_restore_tax")

# wait bucket charged for a gap, by lifecycle state
_WAIT_BUCKET = {
    "queued": "admission_wait",        # engine-only runs: no router leg
    "routed": "router_queue_wait",     # queued behind the router
    "dispatched": "admission_wait",
    "admitted": "interleave_wait",
    "preempted": "preemption_stall",
}


@dataclass
class RequestBreakdown:
    """One request's measured latency, fully partitioned into segments.

    ``segments`` covers ``[arrival, done]``; ``ttft_segments`` is the
    same walk truncated at first token (intervals clipped, launch tax
    pro-rated).  ``pieces`` is the ordered ``(segment, t0, t1)`` timeline
    the Perfetto request track renders.
    """

    rid: int
    replica: Optional[int]
    arrival_s: float
    first_token_s: Optional[float]
    done_s: Optional[float]
    n_tokens: int = 0
    preemptions: int = 0
    segments: dict = field(default_factory=dict)
    ttft_segments: dict = field(default_factory=dict)
    pieces: list = field(default_factory=list)

    @property
    def e2e_s(self) -> float:
        """Measured end-to-end latency (arrival → final token)."""
        if self.done_s is None:
            return 0.0
        return self.done_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        """Measured time-to-first-token (arrival → first emission)."""
        if self.first_token_s is None:
            return 0.0
        return self.first_token_s - self.arrival_s

    @property
    def mean_itl_s(self) -> float:
        """Mean inter-token latency over the decode tail.  The engine's
        final token lands exactly at ``done``, so the mean is derived
        exactly from the anchors — no per-token events needed."""
        if (self.done_s is None or self.first_token_s is None
                or self.n_tokens < 2):
            return 0.0
        return (self.done_s - self.first_token_s) / (self.n_tokens - 1)

    @property
    def conservation_error(self) -> float:
        """|sum(segments) - measured E2E| in seconds."""
        return abs(sum(self.segments.values()) - self.e2e_s)

    @property
    def conserved(self) -> bool:
        """Conservation invariant: segments partition the measured E2E
        (tolerance scales with magnitude for float summation)."""
        return self.conservation_error <= 1e-9 + 1e-6 * abs(self.e2e_s)

    @property
    def dominant(self) -> str:
        """Segment holding the largest share of E2E."""
        return max(SEGMENTS, key=lambda s: self.segments.get(s, 0.0))

    @property
    def ttft_dominant(self) -> str:
        """Segment holding the largest share of TTFT."""
        return max(SEGMENTS, key=lambda s: self.ttft_segments.get(s, 0.0))


def _decompose(trace, until: Optional[float] = None):
    """Partition ``[arrival, end]`` of one trace into segments.

    Returns ``(segments, pieces)``.  ``until`` truncates the walk (the
    TTFT decomposition); exec intervals straddling the cut are clipped
    with their launch tax pro-rated by the surviving fraction.
    """
    done = trace.first("done")
    end = done.t0 if done is not None else max(
        (ev.t1 for ev in trace.events), default=trace.arrival_s)
    if until is not None:
        end = min(end, until)
    segments = {s: 0.0 for s in SEGMENTS}
    pieces: list = []
    has_dispatch = trace.first("dispatch") is not None

    def charge(seg, t0, t1):
        if t1 > t0:
            segments[seg] += t1 - t0
            if pieces and pieces[-1][0] == seg and pieces[-1][2] == t0:
                pieces[-1] = (seg, pieces[-1][1], t1)
            else:
                pieces.append((seg, t0, t1))

    t = trace.arrival_s
    state = "routed" if has_dispatch else "queued"
    pending_tax = 0.0  # modeled offload/restore tax awaiting its stall

    def charge_gap(t0, t1):
        nonlocal pending_tax
        if t1 <= t0:
            return
        if state == "preempted" and pending_tax > 0:
            carve = min(pending_tax, t1 - t0)
            charge("offload_restore_tax", t0, t0 + carve)
            pending_tax -= carve
            t0 += carve
        charge(_WAIT_BUCKET[state], t0, t1)

    for ev in trace.sorted_events():
        t0 = min(max(ev.t0, t), end)
        # restore tax is modeled transfer hiding in the stall that this
        # admit terminates — make it carvable before charging the gap
        if ev.kind == "admit" and state == "preempted":
            pending_tax += ev.meta.get("restore_tax_s", 0.0)
        charge_gap(t, t0)
        t = t0
        if ev.kind in ("prefill", "decode"):
            t1 = min(max(ev.t1, t), end)
            full = ev.t1 - ev.t0
            frac = (t1 - t0) / full if full > 0 else 0.0
            tax = min(t1 - t0, ev.meta.get("tax_s", 0.0) * frac)
            charge("launch_tax", t0, t0 + tax)
            exec_seg = ("prefill_exec" if ev.kind == "prefill"
                        else "decode_exec")
            charge(exec_seg, t0 + tax, t1)
            t = t1
        elif ev.kind == "dispatch":
            if state in ("queued", "routed"):
                state = "dispatched"
        elif ev.kind == "admit":
            state = "admitted"
        elif ev.kind == "preempt":
            state = "preempted"
            pending_tax += ev.meta.get("offload_tax_s", 0.0)
        if t >= end:
            break
    charge_gap(t, end)
    return segments, pieces


def breakdown(trace) -> RequestBreakdown:
    """Decompose one completed trace into a ``RequestBreakdown``."""
    done = trace.first("done")
    ft = trace.first("first_token")
    disp = trace.last("dispatch")
    segments, pieces = _decompose(trace)
    ttft_segments, _ = _decompose(
        trace, until=ft.t0 if ft is not None else None)
    return RequestBreakdown(
        rid=trace.rid,
        replica=(disp.meta.get("replica") if disp is not None else None),
        arrival_s=trace.arrival_s,
        first_token_s=(ft.t0 if ft is not None else None),
        done_s=(done.t0 if done is not None else None),
        n_tokens=(done.meta.get("n_tokens", 0) if done is not None else 0),
        preemptions=trace.count("preempt"),
        segments=segments,
        ttft_segments=ttft_segments,
        pieces=pieces,
    )


@dataclass
class CriticalPathAnalysis:
    """Fleet-wide view over every completed request's decomposition."""

    breakdowns: list
    rejected: list

    @property
    def conservation_ok(self) -> bool:
        """True when every request's partition conserves its E2E."""
        return all(b.conserved for b in self.breakdowns)

    def aggregate(self) -> dict:
        """Total seconds and share per segment across all requests."""
        totals = {s: 0.0 for s in SEGMENTS}
        for b in self.breakdowns:
            for s, v in b.segments.items():
                totals[s] += v
        whole = sum(totals.values())
        return {
            "total_s": totals,
            "share": {s: (v / whole if whole > 0 else 0.0)
                      for s, v in totals.items()},
        }

    def tail_blame(self, q: float = 99.0) -> dict:
        """Blame shares over the TTFT tail: requests at or above the
        ``q``-th TTFT percentile, decomposed by TTFT segment."""
        if not self.breakdowns:
            return {"quantile": q, "threshold_s": 0.0, "n": 0,
                    "share": {}, "dominant": None}
        ttfts = [b.ttft_s for b in self.breakdowns]
        thresh = percentile(ttfts, q)
        tail = [b for b in self.breakdowns if b.ttft_s >= thresh]
        totals = {s: 0.0 for s in SEGMENTS}
        for b in tail:
            for s, v in b.ttft_segments.items():
                totals[s] += v
        whole = sum(totals.values())
        share = {s: (v / whole if whole > 0 else 0.0)
                 for s, v in totals.items()}
        dominant = max(SEGMENTS, key=lambda s: share.get(s, 0.0))
        return {"quantile": q, "threshold_s": thresh, "n": len(tail),
                "share": share, "dominant": dominant}


def analyze(tracer) -> CriticalPathAnalysis:
    """Decompose every completed trace the tracer collected."""
    completed, rejected = [], []
    for rid, tr in sorted(tracer.traces.items()):
        if tr.first("reject") is not None:
            rejected.append(rid)
        elif tr.first("done") is not None:
            completed.append(breakdown(tr))
    return CriticalPathAnalysis(breakdowns=completed, rejected=rejected)


# ---------------------------------------------------------------- SLOs
@dataclass(frozen=True)
class SLO:
    """Per-request latency objectives (None = unconstrained)."""

    ttft_s: Optional[float] = None
    itl_s: Optional[float] = None

    @classmethod
    def from_scenario(cls, scenario) -> "SLO":
        """Adopt the scenario's registered default thresholds."""
        return cls(ttft_s=scenario.slo_ttft_s, itl_s=scenario.slo_itl_s)

    @classmethod
    def resolve(cls, scenario=None, ttft_ms=None, itl_ms=None) -> "SLO":
        """CLI-flag resolution: explicit ``--slo-*-ms`` values override
        the scenario's registered defaults; 0 (or negative) disables
        that bound entirely."""
        ttft = scenario.slo_ttft_s if scenario is not None else None
        itl = scenario.slo_itl_s if scenario is not None else None
        if ttft_ms is not None:
            ttft = ttft_ms / 1e3 if ttft_ms > 0 else None
        if itl_ms is not None:
            itl = itl_ms / 1e3 if itl_ms > 0 else None
        return cls(ttft_s=ttft, itl_s=itl)

    def verdict(self, b: RequestBreakdown) -> str:
        """``met`` / ``ttft`` / ``itl`` / ``both`` for one request."""
        miss_ttft = self.ttft_s is not None and b.ttft_s > self.ttft_s
        miss_itl = self.itl_s is not None and b.mean_itl_s > self.itl_s
        if miss_ttft and miss_itl:
            return "both"
        if miss_ttft:
            return "ttft"
        if miss_itl:
            return "itl"
        return "met"


def _post_ttft_dominant(b: RequestBreakdown) -> str:
    """Dominant segment of the decode tail (E2E minus the TTFT leg) —
    the blame target for ITL-only violators."""
    post = {s: max(0.0, b.segments.get(s, 0.0) - b.ttft_segments.get(s, 0.0))
            for s in SEGMENTS}
    return max(SEGMENTS, key=lambda s: post.get(s, 0.0))


def slo_report(analysis: CriticalPathAnalysis, slo: SLO) -> dict:
    """Classify every completed request against ``slo``.

    Returns verdict counts, the goodput ratio, and a per-segment blame
    table: TTFT violators blame their dominant TTFT segment, ITL-only
    violators the dominant segment of their decode tail.
    """
    verdicts = {"met": 0, "ttft": 0, "itl": 0, "both": 0}
    blame = {s: 0 for s in SEGMENTS}
    per_request = []
    for b in analysis.breakdowns:
        v = slo.verdict(b)
        verdicts[v] += 1
        if v in ("ttft", "both"):
            blame[b.ttft_dominant] += 1
        elif v == "itl":
            blame[_post_ttft_dominant(b)] += 1
        per_request.append({"rid": b.rid, "verdict": v})
    n = len(analysis.breakdowns)
    return {
        "slo": {"ttft_s": slo.ttft_s, "itl_s": slo.itl_s},
        "n_requests": n,
        "verdicts": verdicts,
        "goodput_ratio": (verdicts["met"] / n if n else 0.0),
        "blame": blame,
        "per_request": per_request,
    }


def record_goodput(registry, report: dict) -> None:
    """Publish the SLO report as first-class registry families, ready
    for the future SLO-aware scheduler to consume live:

      goodput_requests_total{verdict}   completed requests per verdict
      goodput_blame_total{segment}      violators per dominant segment
      goodput_ratio                     fraction of requests meeting SLO
      slo_ttft_seconds / slo_itl_seconds   active thresholds (gauges)
    """
    req = registry.counter(
        "goodput_requests_total",
        help="completed requests by SLO verdict (met/ttft/itl/both)",
        labels=("verdict",))
    for verdict, n in report["verdicts"].items():
        if n:
            req.inc(n, verdict=verdict)
    blame = registry.counter(
        "goodput_blame_total",
        help="SLO violators by dominant critical-path blame segment",
        labels=("segment",))
    for seg, n in report["blame"].items():
        if n:
            blame.inc(n, segment=seg)
    registry.gauge(
        "goodput_ratio",
        help="fraction of completed requests meeting their SLO",
    ).set(report["goodput_ratio"])
    slo = report["slo"]
    if slo.get("ttft_s") is not None:
        registry.gauge("slo_ttft_seconds",
                       help="active TTFT SLO threshold").set(slo["ttft_s"])
    if slo.get("itl_s") is not None:
        registry.gauge("slo_itl_seconds",
                       help="active ITL SLO threshold").set(slo["itl_s"])


def triage(analysis: CriticalPathAnalysis, slo: Optional[SLO] = None,
           tail_q: float = 99.0) -> dict:
    """The ``--trace-out`` report: conservation status, aggregate blame,
    per-request waterfalls, SLO/goodput verdicts, and the TTFT-tail
    blame table."""
    waterfall = []
    for b in analysis.breakdowns:
        waterfall.append({
            "rid": b.rid,
            "replica": b.replica,
            "arrival_s": b.arrival_s,
            "ttft_s": b.ttft_s,
            "mean_itl_s": b.mean_itl_s,
            "e2e_s": b.e2e_s,
            "n_tokens": b.n_tokens,
            "preemptions": b.preemptions,
            "segments": dict(b.segments),
            "ttft_segments": dict(b.ttft_segments),
            "dominant": b.dominant,
            "ttft_dominant": b.ttft_dominant,
            "conservation_error_s": b.conservation_error,
            "conserved": b.conserved,
        })
    out = {
        "n_requests": len(analysis.breakdowns),
        "n_rejected": len(analysis.rejected),
        "conservation": {
            "ok": analysis.conservation_ok,
            "max_error_s": max(
                (b.conservation_error for b in analysis.breakdowns),
                default=0.0),
        },
        "aggregate": analysis.aggregate(),
        "tail": analysis.tail_blame(tail_q),
        "waterfall": waterfall,
    }
    if slo is not None and (slo.ttft_s is not None
                            or slo.itl_s is not None):
        out["slo_report"] = slo_report(analysis, slo)
    return out
