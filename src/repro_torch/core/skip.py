"""SKIP facade: trace -> measure -> simulate -> classify -> plan -> execute.

Copy of ``repro/core/skip.py``.  SKIP is a thin convenience layer over
``repro_torch.runtime``: tracing produces a ``Trace``, every execution path
(eager, chain-fused, whole-graph, cost-aware auto) is a ``LaunchPlan``,
``Planner`` compares candidate plans analytically against the TKLQT device
model, and ``PlanExecutor`` compiles/caches/runs the winner.  The legacy
methods below keep their signatures and delegate.

Typical use:

    skip = SKIP.trace(forward_fn, *example_args)
    skip.measure_host()                      # real dispatch costs, this host
    rep = skip.report("GH200", batch=8)      # modeled platform timeline
    sweep = skip.batch_sweep("GH200")        # TKLQT curve + inflection
    recs = skip.recommend(length=16)         # PS=1 chains (Eq. 6)
    outcome = skip.fuse(length=16)           # chain plan: fuse + measure
    choice = skip.plan("GH200")              # cost-aware auto LaunchPlan
    ex = skip.executor(choice.plan)          # segment executor
    SKIP.characterize(cfg, params, ...)      # measured serving sweep
    SKIP.autotune(cfg, params, ...)          # measured plan table
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Sequence, Union

from repro_torch.core import boundedness as bnd
from repro_torch.core import proximity as prox
from repro_torch.core.device_model import PLATFORMS, PlatformSpec, simulate
from repro_torch.core.fusion import FusionOutcome, apply_fusion
from repro_torch.core.metrics import SkipReport, report
from repro_torch.core.tracing import Trace, trace_fn

# repro_torch.runtime is imported inside the methods, as the reference
# does, to keep the import graph acyclic
if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.runtime import (LaunchPlan, PlanChoice, PlanExecutor,
                                     Planner)

DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclass
class SKIP:
    trace_: Trace
    args: tuple
    base_batch: int = 1
    host_measured: bool = False

    # ------------------------------------------------------------ build
    @classmethod
    def trace(cls, fn, *args, base_batch: int = 1) -> "SKIP":
        return cls(trace_=trace_fn(fn, *args), args=args,
                   base_batch=base_batch)

    def measure_host(self, repeats: int = 3):
        from repro_torch.runtime import PlanExecutor
        PlanExecutor(self.trace_).measure_host(*self.args, repeats=repeats)
        self.host_measured = True

    # ------------------------------------------------------------ modeling
    def _host_scale(self):
        if not self.host_measured:
            return None
        ts = [k.host_dispatch_s for k in self.trace_.kernels]
        null = min(t for t in ts if t > 0) if any(ts) else 1.0
        return [t / null if t > 0 else 1.0 for t in ts]

    def timeline(self, platform: str, batch: Optional[int] = None,
                 use_host_scale: bool = True):
        """use_host_scale=True: launch costs follow THIS host's measured
        per-op dispatch profile (JAX eager reality).  False: the platform's
        nullKernel constant for every op (the paper's C++-runtime physics —
        use for reproducing paper figures)."""
        spec = PLATFORMS[platform]
        scale = (batch or self.base_batch) / self.base_batch
        hs = self._host_scale() if use_host_scale else None
        return simulate(self.trace_.kernels, spec, batch_scale=scale,
                        host_scale=hs)

    def report(self, platform: str, batch: Optional[int] = None,
               top_k: int = 5, use_host_scale: bool = True) -> SkipReport:
        spec = PLATFORMS[platform]
        ev = self.timeline(platform, batch, use_host_scale=use_host_scale)
        return report(ev, platform, spec.launch_overhead_ns * 1e-9, k=top_k)

    def batch_sweep(self, platform: str,
                    batches: Sequence[int] = DEFAULT_BATCHES,
                    use_host_scale: bool = True):
        reps = [self.report(platform, b, use_host_scale=use_host_scale)
                for b in batches]
        return bnd.classify_sweep(batches, reps), reps

    # ------------------------------------------------------------ planning
    def planner(self, platform: Union[str, PlatformSpec] = "TPU-v5e",
                batch: Optional[int] = None,
                use_host_scale: bool = True) -> "Planner":
        from repro_torch.runtime import Planner
        scale = (batch or self.base_batch) / self.base_batch
        hs = self._host_scale() if use_host_scale else None
        return Planner(self.trace_, platform, batch_scale=scale,
                       host_scale=hs)

    def plan(self, platform: Union[str, PlatformSpec] = "TPU-v5e",
             lengths: Sequence[int] = (2, 4, 8, 16, 32),
             batch: Optional[int] = None) -> "PlanChoice":
        """Cost-aware auto plan: lowest modeled TKLQT among candidates."""
        return self.planner(platform, batch=batch).auto(lengths=lengths)

    def executor(self, plan: Optional["LaunchPlan"] = None) -> "PlanExecutor":
        from repro_torch.runtime import PlanExecutor
        return PlanExecutor(self.trace_, plan)

    # ------------------------------------------------------------ measured
    @staticmethod
    def characterize(cfg, params, **kw):
        """Measured serving characterization: drive the live ServeEngine
        with a named traffic scenario, sweep batch sizes, aggregate
        TTFT/ITL/E2E percentiles and measured launch tax, and classify the
        CPU/GPU-bound inflection from the measured curve.  Thin facade
        over ``repro_torch.telemetry.characterize.characterize`` (same
        kwargs: scenario, batches, plan, platform, n_requests, seed,
        workload, device...).
        """
        from repro_torch.telemetry.characterize import characterize
        return characterize(cfg, params, **kw)

    @staticmethod
    def autotune(cfg, params, **kw):
        """Measurement-driven plan autotuning: characterize, gate the
        candidate plans by the measured CPU/GPU-bound region, benchmark
        them on the live engine, and return the persisted-plan-table
        result.  Thin facade over ``repro_torch.runtime.autotune.autotune``.
        """
        from repro_torch.runtime.autotune import autotune
        return autotune(cfg, params, **kw)

    # ------------------------------------------------------------ fusion
    def recommend(self, length: int = 8, threshold: float = 1.0):
        return prox.mine_chains(self.trace_.kernel_names, length, threshold)

    def recommend_sweep(self, lengths=(2, 4, 8, 16, 32, 64, 128, 256)):
        return prox.sweep_lengths(self.trace_.kernel_names, lengths)

    def fuse(self, length: int = 8, repeats: int = 3) -> FusionOutcome:
        return apply_fusion(self.trace_, *self.args, length=length,
                            repeats=repeats)
