"""Operator→kernel attribution: resolve every launch to the model
operator that issued it.

Copy of ``repro/telemetry/attribution.py``.  Provenance flows in three
hops: ``torch.profiler.record_function`` scopes in ``models/transformer.py``
(named as the reference's ``jax.named_scope`` tags) land in the traced
graph as marker nodes, which ``core.tracing`` turns into each
``Kernel.operator`` path; launch-plan segments group
kernels, so a segment's single dispatch is split across its members'
operators by kernel count (a fused-rule segment attributes fractionally
to its constituent ops); and ``simulate_plan``'s per-segment
``KernelEvent`` timeline supplies the launch/queue/exec decomposition
each fraction prices against.

Launch counts accumulate as ``fractions.Fraction`` so the acceptance
invariant — attribution accounts for 100% of dispatches — is exact
arithmetic, not a float tolerance.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional, Sequence

# canonical op kinds, in display order (attention / mlp /
# norm / collective / draft + the stack's edge ops)
OP_KINDS = ("attention", "mlp", "norm", "embed", "unembed", "residual",
            "mamba", "rwkv", "moe", "collective", "draft", "other")

# scope-path component -> canonical op kind (first match along the path,
# innermost component first, wins)
_COMPONENT_OP = {
    "attn": "attention", "attn_local": "attention", "xattn": "attention",
    "mlp": "mlp", "rwkv_channel": "mlp",
    "moe": "moe",
    "norm1": "norm", "norm2": "norm", "norm": "norm",
    "final_norm": "norm", "norm_x": "norm",
    "embed": "embed", "unembed": "unembed",
    "resid": "residual",
    "mamba": "mamba", "rwkv": "rwkv",
}

# primitive names that are collectives regardless of scope
_COLLECTIVE_PRIMS = {"psum", "all_reduce", "all_gather", "ppermute",
                     "all_to_all", "reduce_scatter", "psum_scatter"}

_LAYER_RE = re.compile(r"^layer(\d+)$")


@dataclass(frozen=True)
class OpTag:
    """Parsed provenance of one kernel."""
    op: str                        # canonical kind from OP_KINDS
    layer: Optional[int]           # layer index, when the scope names one
    raw: str                       # the full named_scope path

    def key(self, by_layer: bool = False) -> str:
        if by_layer and self.layer is not None:
            return f"layer{self.layer}/{self.op}"
        return self.op


def parse_operator(raw: str, kernel_name: str = "") -> OpTag:
    """Map a scope path (+ op name) to its canonical tag."""
    if kernel_name in _COLLECTIVE_PRIMS:
        return OpTag("collective", _scope_layer(raw), raw)
    if raw.startswith("draft"):
        return OpTag("draft", None, raw)
    layer = _scope_layer(raw)
    # innermost component wins: "layer0/slot0/attn" -> attention even
    # though einsum sub-scopes may trail it
    for comp in reversed(raw.split("/")):
        op = _COMPONENT_OP.get(comp)
        if op is not None:
            return OpTag(op, layer, raw)
    return OpTag("other", layer, raw)


def _scope_layer(raw: str) -> Optional[int]:
    for comp in raw.split("/"):
        m = _LAYER_RE.match(comp)
        if m:
            return int(m.group(1))
    return None


def segment_ops(kernels: Sequence, seg: Sequence,
                by_layer: bool = False) -> dict:
    """Kernel count per canonical op for one plan segment."""
    counts: dict = {}
    for i in seg:
        k = kernels[i]
        tag = parse_operator(getattr(k, "operator", ""), k.name)
        key = tag.key(by_layer)
        counts[key] = counts.get(key, 0) + 1
    return counts


@dataclass
class OperatorRow:
    """Attributed totals for one operator across a dispatch timeline."""
    operator: str
    launches: Fraction = Fraction(0)
    kernels: int = 0
    launch_s: float = 0.0
    queue_s: float = 0.0
    exec_s: float = 0.0

    @property
    def tklqt_s(self) -> float:
        return self.launch_s + self.queue_s

    def as_dict(self, total_tklqt_s: float = 0.0) -> dict:
        return {
            "operator": self.operator,
            "launches": float(self.launches),
            "kernels": self.kernels,
            "launch_us": self.launch_s * 1e6,
            "queue_us": self.queue_s * 1e6,
            "exec_us": self.exec_s * 1e6,
            "tklqt_us": self.tklqt_s * 1e6,
            "tklqt_pct": (100.0 * self.tklqt_s / total_tklqt_s
                          if total_tklqt_s > 0 else 0.0),
        }


@dataclass
class AttributionReport:
    """Per-operator decomposition of one simulated dispatch timeline."""
    rows: list = field(default_factory=list)   # [OperatorRow], tklqt desc
    total_events: int = 0

    @property
    def accounted_launches(self) -> Fraction:
        return sum((r.launches for r in self.rows), Fraction(0))

    @property
    def complete(self) -> bool:
        """Exact (rational-arithmetic) 100%-of-dispatches check."""
        return self.accounted_launches == self.total_events

    @property
    def tklqt_s(self) -> float:
        return sum(r.tklqt_s for r in self.rows)

    def top_k(self, k: int) -> list:
        return self.rows[:k]

    def as_dicts(self) -> list:
        total = self.tklqt_s
        return [r.as_dict(total) for r in self.rows]


def attribute_events(kernels: Sequence, plan, events: Sequence,
                     by_layer: bool = False) -> AttributionReport:
    """Attribute a ``simulate_plan`` timeline to model operators.

    ``events`` is the planner's modeled timeline: optional host-only
    ``draft_launch[i]`` events first, then exactly one ``KernelEvent``
    per plan segment, in plan order.  Each segment's launch/queue/exec
    time splits across its member kernels' operators proportionally to
    kernel count, so fused segments attribute to their constituent ops
    and Σ launches over rows equals len(events) exactly.
    """
    rows: dict = {}

    def row(key: str) -> OperatorRow:
        r = rows.get(key)
        if r is None:
            r = rows[key] = OperatorRow(key)
        return r

    si = 0
    segments = plan.segments
    for e in events:
        if e.name.startswith("draft_launch["):
            r = row("draft")
            r.launches += 1
            r.launch_s += e.t_launch
            r.queue_s += e.t_queue
            r.exec_s += e.duration
            continue
        if si >= len(segments):
            raise ValueError(
                f"timeline has more segment events than plan segments "
                f"({len(segments)}); extra event {e.name!r}")
        seg = segments[si]
        si += 1
        counts = segment_ops(kernels, seg, by_layer)
        n = len(seg)
        for key, c in counts.items():
            frac = Fraction(c, n)
            r = row(key)
            r.launches += frac
            r.kernels += c
            w = float(frac)
            r.launch_s += e.t_launch * w
            r.queue_s += e.t_queue * w
            r.exec_s += e.duration * w
    if si != len(segments):
        raise ValueError(
            f"timeline covered {si} of {len(segments)} plan segments")
    ordered = sorted(rows.values(), key=lambda r: -r.tklqt_s)
    return AttributionReport(rows=ordered, total_events=len(events))


def merge_report(dst: dict, report: AttributionReport,
                 calls: int = 1) -> dict:
    """Accumulate a per-call report into a running per-operator dict
    (used by the engine to aggregate over every decode call)."""
    for r in report.rows:
        acc = dst.get(r.operator)
        if acc is None:
            acc = dst[r.operator] = OperatorRow(r.operator)
        acc.launches += r.launches * calls
        acc.kernels += r.kernels * calls
        acc.launch_s += r.launch_s * calls
        acc.queue_s += r.queue_s * calls
        acc.exec_s += r.exec_s * calls
    return dst
