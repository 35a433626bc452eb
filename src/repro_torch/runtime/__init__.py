"""Launch-plan runtime: one plan -> capture -> execute subsystem.

Counterpart of ``repro/runtime``: ``LaunchPlan`` partitions a kernel
trace, ``Planner`` picks boundaries analytically against the TKLQT device
model, ``PlanExecutor`` runs the plan's segments directly or as CUDA
graphs, and ``runtime.autotune`` picks a plan per slot-pool size from
measured serving (``PlanTable``, served by
``ServeEngine(plan="autotuned")``).
"""
from repro_torch.runtime.executor import (PlanExecutor,  # noqa: F401
                                          cache_stats, clear_cache)
from repro_torch.runtime.plan import LaunchPlan  # noqa: F401
from repro_torch.runtime.planner import (PlanChoice,  # noqa: F401
                                         PlanEvaluation, Planner,
                                         simulate_plan)
from repro_torch.runtime.rules import (DEFAULT_RULES,  # noqa: F401
                                       find_matches, fused_plan, get_rule)
