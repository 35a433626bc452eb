"""LaunchPlan: the unit of the plan -> capture -> execute lifecycle.

Copy of ``repro/runtime/plan.py``.  A plan partitions a kernel trace
(``core.tracing``) into an ordered, exact cover of contiguous segments.
On the card each segment runs as ONE dispatch (a CUDA graph replay, or a
direct call for a segment of views), so ``n_launches == len(segments)``
is the dispatch count the paper's TKLQT model prices.  Strategies:

  eager        one segment per node (per-op dispatch, PyTorch eager)
  whole_graph  one segment for the whole trace (one CUDA graph)
  chain(L)     proximity-mined deterministic chains of length L (paper Eq. 6)
  auto         cost-aware boundaries from ``runtime.planner.Planner``
  fused        rule windows lowered to the hand-written norm kernels
               (``runtime.rules``), remainder from a base plan

``rules`` tags segments that execute as ONE fused kernel instead of a
node replay: ``(segment_index, rule_name)`` pairs resolved against the
``runtime.rules`` registry when the executor builds the plan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.proximity import fusion_segments


def segment_label(kernels: Sequence, seg: Sequence[int]) -> str:
    """Display name of one plan segment: the first member kernel's name,
    prefixed with the fused count when the segment spans several."""
    name = kernels[seg[0]].name
    return name if len(seg) == 1 else f"fused[{len(seg)}]:{name}"


@dataclass(frozen=True)
class LaunchPlan:
    strategy: str                       # eager | whole_graph | chain | auto |
                                        # fused | custom
    segments: tuple                     # tuple[tuple[int, ...], ...]
    length: Optional[int] = None        # chain length, when strategy == "chain"
    rules: tuple = ()                   # tuple[(segment_index, rule_name)]

    @property
    def n_launches(self) -> int:
        return len(self.segments)

    @property
    def n_fused_rules(self) -> int:
        return len(self.rules)

    def rule_names(self) -> list:
        return [name for _, name in self.rules]

    @property
    def n_kernels(self) -> int:
        return sum(len(s) for s in self.segments)

    @property
    def max_segment(self) -> int:
        return max((len(s) for s in self.segments), default=0)

    def key(self) -> tuple:
        """Hashable identity used by the compiled-segment cache."""
        return (self.strategy, self.length, self.segments, self.rules)

    def validate(self, n_kernels: Optional[int] = None) -> "LaunchPlan":
        """Segments must be an exact in-order cover of the kernel indices —
        that is the invariant that makes any plan numerically equivalent to
        eager execution (program order is preserved)."""
        flat = [i for seg in self.segments for i in seg]
        n = n_kernels if n_kernels is not None else len(flat)
        if flat != list(range(n)):
            raise ValueError(
                "plan segments are not an exact in-order cover of "
                f"range({n}): {flat[:8]}...")
        return self

    def describe(self) -> str:
        return (f"LaunchPlan({self.strategy}"
                + (f", L={self.length}" if self.length else "")
                + (f", {self.n_fused_rules} fused" if self.rules else "")
                + f": {self.n_launches} launches / {self.n_kernels} kernels, "
                  f"max segment {self.max_segment})")

    # ------------------------------------------------------------ builders
    @staticmethod
    def eager(n_kernels: int) -> "LaunchPlan":
        return LaunchPlan("eager", tuple((i,) for i in range(n_kernels)))

    @staticmethod
    def whole_graph(n_kernels: int) -> "LaunchPlan":
        return LaunchPlan("whole_graph", (tuple(range(n_kernels)),))

    @staticmethod
    def chain(kernel_names: Sequence[str], length: int,
              mining=None) -> "LaunchPlan":
        segs = fusion_segments(kernel_names, length, mining=mining)
        return LaunchPlan("chain", tuple(tuple(s) for s in segs),
                          length=length).validate(len(kernel_names))

    @staticmethod
    def from_segments(segments: Sequence[Sequence[int]],
                      strategy: str = "custom",
                      length: Optional[int] = None) -> "LaunchPlan":
        return LaunchPlan(strategy, tuple(tuple(s) for s in segments),
                          length=length).validate()
