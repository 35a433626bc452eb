"""Planner: compare candidate LaunchPlans analytically, pick the winner.

Copy of ``repro/runtime/planner.py``; the backend prices plans on the
port's ``Intel+H100`` row.  Every number it gives is MODELED.

The queue model of ``core.device_model`` runs at *segment* granularity
here: one host launch per segment, device time = sum of the member
kernels' modeled durations.  That is exactly the paper's fusion economics
— fusing a chain removes (len-1) launches but not the device work — so
``Planner.auto`` can choose segment boundaries that minimize modeled
TKLQT (or IL) for a target PlatformSpec before anything is compiled.

The auto partitioner walks the kernel stream and keeps extending the
current segment while kernels stay launch-dominated (modeled duration <
modeled host dispatch cost, i.e. the CPU-bound region TKLQT identifies);
a device-bound kernel breaks the segment and stays solo, because its
launch hides behind the running device queue and fusing it buys no TKLQT.
Whole-graph compilation would trivially minimize TKLQT but pays the
compile-time tax the paper's Table I measures, so it is excluded from
``auto`` by default and kept as an explicit strategy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

from repro_torch.core.device_model import (KernelEvent, PLATFORMS,
                                           PlatformSpec, allreduce_cost_s,
                                           dispatch_fanout_s,
                                           kernel_duration)
from repro_torch.core.metrics import SkipReport, report
from repro_torch.core.tracing import Trace
from repro_torch.runtime.plan import LaunchPlan, segment_label

DEFAULT_LENGTHS = (2, 4, 8, 16, 32)


def simulate_plan(kernels: Sequence, plan: LaunchPlan, spec: PlatformSpec, *,
                  batch_scale: float = 1.0,
                  host_scale: Optional[Sequence[float]] = None,
                  tp: int = 1,
                  collective_bytes: Union[float, Sequence, None] = None,
                  draft_launches: int = 0) -> list[KernelEvent]:
    """In-order queue model over plan segments (one launch per segment).

    Rule-tagged segments (``plan.rules``) are priced as ONE fused kernel:
    the member flops still run, but the memory traffic collapses to the
    widest member tensor — the fused kernel keeps intermediates on chip,
    so only the segment-boundary arrays cross HBM.  Plain multi-node
    segments keep the sum of member durations (one CUDA graph replay
    dispatches them, but the member kernels still round-trip memory).

    ``tp`` prices a tensor-parallel execution of the same stream: the host
    issues every segment's launch once PER DEVICE STREAM (launch cost x
    tp — the multi-GPU widening of the CPU-bound region), while each
    device runs 1/tp of the segment's flops/bytes.  ``collective_bytes``
    adds all-reduce payload on top, priced over the platform's coupling
    link via ``allreduce_cost_s`` and serialized on the device timeline
    (decode-size payloads are latency-floor dominated, so overlap is not
    assumed).  Pass a per-segment sequence to localize payloads at their
    all-reduce sites (each nonzero entry pays its own ring-latency floor),
    or one scalar total priced as a single aggregate all-reduce after the
    final segment (no per-site latency knowledge).  Nothing executes
    sharded: this is the model the ``tp_sweep`` prices.

    ``draft_launches`` prepends that many speculative-draft dispatches to
    the host timeline: the draft model is its own single-device stream
    whose kernels are tiny (device time hides behind the queue) but whose
    LAUNCHES serialize on the host before the batched verify can issue —
    the launch-tax side of the speculation trade.  Each costs one tp=1
    ``dispatch_fanout_s`` of host time and no modeled device work.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if draft_launches < 0:
        raise ValueError(
            f"draft_launches must be >= 0, got {draft_launches}")
    n_segs = len(plan.segments)
    if collective_bytes is None:
        coll = [0.0] * n_segs
    elif isinstance(collective_bytes, (int, float)):
        coll = [0.0] * n_segs
        if n_segs:
            coll[-1] = float(collective_bytes)
    else:
        if len(collective_bytes) != n_segs:
            raise ValueError(
                f"collective_bytes has {len(collective_bytes)} entries "
                f"for {n_segs} plan segments")
        coll = list(collective_bytes)
    rule_segs = {si for si, _ in plan.rules}
    t_host = 0.0
    device_free = 0.0
    events = []
    draft_cost = dispatch_fanout_s(spec, 1)     # draft runs single-device
    for di in range(draft_launches):
        launch_begin = t_host
        t_host += draft_cost
        events.append(KernelEvent(f"draft_launch[{di}]", launch_begin,
                                  t_host, t_host, t_host))
    base_launch = dispatch_fanout_s(spec, tp)   # one launch per device stream
    work_scale = batch_scale / tp
    for si, seg in enumerate(plan.segments):
        rel = 1.0
        if host_scale is not None and len(seg) == 1:
            # singleton segments keep this op's measured host profile;
            # fused segments dispatch as one executable at the base cost
            rel = max(host_scale[seg[0]], 1.0)
        launch_begin = t_host
        t_host = t_host + base_launch * rel
        if si in rule_segs:
            dur = kernel_duration(
                spec,
                sum(kernels[i].flops for i in seg) * work_scale,
                max(kernels[i].bytes for i in seg) * work_scale)
        else:
            dur = sum(kernel_duration(spec, kernels[i].flops * work_scale,
                                      kernels[i].bytes * work_scale)
                      for i in seg)
        if coll[si]:                # zero-byte sites pay no latency floor
            dur += allreduce_cost_s(spec, coll[si], tp)
        start = max(t_host, device_free)
        end = start + dur
        device_free = end
        # operator provenance rides onto the modeled event when the
        # segment is homogeneous (always true for eager singletons);
        # mixed fused segments stay untagged — attribution splits those
        # fractionally from segment_ops instead
        ops = {getattr(kernels[i], "operator", "") for i in seg}
        events.append(KernelEvent(segment_label(kernels, seg),
                                  launch_begin, t_host, start, end,
                                  operator=ops.pop() if len(ops) == 1
                                  else ""))
    return events


@dataclass
class PlanEvaluation:
    plan: LaunchPlan
    report: SkipReport

    @property
    def tklqt(self) -> float:
        return self.report.tklqt

    @property
    def il(self) -> float:
        return self.report.il


@dataclass
class PlanChoice:
    plan: LaunchPlan
    report: SkipReport
    evaluated: list                     # every PlanEvaluation considered


class Planner:
    """Analytic plan search over one trace for one target platform."""

    def __init__(self, trace: Trace,
                 platform: Union[str, PlatformSpec] = "TPU-v5e", *,
                 batch_scale: float = 1.0,
                 host_scale: Optional[Sequence[float]] = None,
                 tp: int = 1,
                 collective_bytes: Union[float, Sequence, None] = None,
                 draft_launches: int = 0):
        self.trace = trace
        self.spec = (PLATFORMS[platform] if isinstance(platform, str)
                     else platform)
        self.batch_scale = batch_scale
        self.host_scale = host_scale
        # tensor-parallel pricing: launch streams multiply, per-device
        # work divides, collective payload rides the coupling link
        self.tp = tp
        self.collective_bytes = collective_bytes
        # speculative pricing: the draft's dispatches serialize before
        # the verify stream (see simulate_plan)
        self.draft_launches = draft_launches

    # ------------------------------------------------------------ plans
    def eager(self) -> LaunchPlan:
        return LaunchPlan.eager(len(self.trace.kernels))

    def whole_graph(self) -> LaunchPlan:
        return LaunchPlan.whole_graph(len(self.trace.kernels))

    def chain(self, length: int) -> LaunchPlan:
        return LaunchPlan.chain(self.trace.kernel_names, length)

    def cost_partition(self, max_segment: int = 128) -> LaunchPlan:
        """TKLQT-aware boundaries: fuse runs of launch-dominated kernels,
        leave device-bound kernels solo (their launches are hidden)."""
        launch_s = self.spec.host_cost_ns * 1e-9
        segs, cur = [], []
        for i, k in enumerate(self.trace.kernels):
            dur = kernel_duration(self.spec, k.flops * self.batch_scale,
                                  k.bytes * self.batch_scale)
            if dur >= launch_s:
                if cur:
                    segs.append(cur)
                    cur = []
                segs.append([i])
            else:
                cur.append(i)
                if len(cur) >= max_segment:
                    segs.append(cur)
                    cur = []
        if cur:
            segs.append(cur)
        return LaunchPlan("auto", tuple(tuple(s) for s in segs)).validate(
            len(self.trace.kernels))

    def fused_rules(self, lengths: Sequence[int] = DEFAULT_LENGTHS,
                    rules: Optional[Sequence[str]] = None,
                    verify: bool = True) -> LaunchPlan:
        """Fusion-rule plan: verified rule windows become single launches
        of the hand-written norm kernels, the remainder keeps the
        cost-aware auto partition — the paper's 'substitute fused kernels
        in the CPU-bound region' move, as a LaunchPlan."""
        from repro_torch.runtime.rules import DEFAULT_RULES, fused_plan
        base = self.auto(lengths=lengths).plan
        return fused_plan(self.trace, base=base,
                          rules=rules or DEFAULT_RULES, verify=verify)

    # ------------------------------------------------------------ search
    def evaluate(self, plan: LaunchPlan) -> SkipReport:
        ev = simulate_plan(self.trace.kernels, plan, self.spec,
                           batch_scale=self.batch_scale,
                           host_scale=self.host_scale, tp=self.tp,
                           collective_bytes=self.collective_bytes,
                           draft_launches=self.draft_launches)
        return report(ev, self.spec.name, self.spec.launch_overhead_ns * 1e-9)

    def compare(self, plans: Sequence[LaunchPlan],
                objective: str = "tklqt") -> list[PlanEvaluation]:
        evals = [PlanEvaluation(p, self.evaluate(p)) for p in plans]
        evals.sort(key=lambda e: (getattr(e, objective), e.report.il,
                                  e.plan.n_launches))
        return evals

    def auto(self, lengths: Sequence[int] = DEFAULT_LENGTHS,
             objective: str = "tklqt",
             include_whole_graph: bool = False,
             include_eager: bool = False) -> PlanChoice:
        """Pick the candidate plan with the lowest modeled TKLQT (or IL).

        Candidates: the cost-aware partition plus every chain(L); the
        winner's modeled objective is therefore never worse than the best
        fixed-length chain plan.
        """
        n = len(self.trace.kernels)
        cands = [self.cost_partition()]
        cands += [self.chain(L) for L in lengths if 1 < L <= max(n, 1)]
        if include_whole_graph:
            cands.append(self.whole_graph())
        if include_eager:
            cands.append(self.eager())
        evals = self.compare(cands, objective=objective)
        best = evals[0]
        return PlanChoice(best.plan, best.report, evals)
