"""Launch-plan runtime: one plan -> capture -> execute subsystem.

Counterpart of ``repro/runtime``: ``LaunchPlan`` partitions a kernel
trace, ``Planner`` picks boundaries analytically against the TKLQT device
model, ``PlanExecutor`` runs the plan's segments directly or as CUDA
graphs.  ``runtime/autotune.py`` comes with ROADMAP Queue A's "measured
characterization and autotune" item.
"""
from repro_torch.runtime.executor import (PlanExecutor,  # noqa: F401
                                          cache_stats, clear_cache)
from repro_torch.runtime.plan import LaunchPlan  # noqa: F401
from repro_torch.runtime.planner import (PlanChoice,  # noqa: F401
                                         PlanEvaluation, Planner,
                                         simulate_plan)
from repro_torch.runtime.rules import (DEFAULT_RULES,  # noqa: F401
                                       find_matches, fused_plan, get_rule)
