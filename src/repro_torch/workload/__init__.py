"""Workload subsystem: scenario registry, seeded generators, JSONL replay.

Copy of ``repro/workload``: the same scenarios, the same seeded draws in
the same order and the same canonical JSONL, so a workload generated or
saved by either package is the other's, field for field and byte for byte.
"""
from repro_torch.workload.generator import (  # noqa: F401
    Workload, WorkloadRequest, sample_requests,
)
from repro_torch.workload.scenarios import (  # noqa: F401
    LengthDist, Scenario, get_scenario, list_scenarios, register_scenario,
)
from repro_torch.workload.trace_io import (  # noqa: F401
    load_workload, save_workload,
)
