"""The paper's primary contribution on the aten op stream: the SKIP
profiler, TKLQT metrics, PU-boundedness classification, proximity-score
fusion mining and chain fusion (counterpart of ``repro.core``)."""
from repro_torch.core.skip import SKIP                       # noqa: F401
from repro_torch.core.device_model import PLATFORMS          # noqa: F401
from repro_torch.core.proximity import mine_chains, sweep_lengths  # noqa: F401
from repro_torch.core.fusion import apply_fusion             # noqa: F401
from repro_torch.core.boundedness import (classify_sweep,    # noqa: F401
                                          find_inflection)
from repro_torch.core.tracing import Executor, trace_fn      # noqa: F401
# the launch-plan runtime lives in repro_torch.runtime (LaunchPlan,
# Planner, PlanExecutor); it is not re-exported here to keep the import
# graph acyclic
