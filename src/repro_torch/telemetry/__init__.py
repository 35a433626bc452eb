"""Telemetry subsystem: span recording, latency metrics, measured sweeps.

Counterpart of ``repro/telemetry/__init__.py``.  Only the
dependency-light pieces (spans, metrics, the registry, the request tracer
and its critical-path analysis) import eagerly: the serving engine imports ``telemetry.metrics``, so this
package init must not import the engine back (``characterize`` does, and
``monitor`` imports ``characterize``).  Those two are re-exported lazily
(through ``importlib``: the reference's ``from repro.telemetry import
characterize`` inside its own ``__getattr__`` recurses when the submodule
is not loaded yet).
"""
import importlib

from repro_torch.telemetry.attribution import (  # noqa: F401
    AttributionReport, OperatorRow, OpTag, attribute_events, merge_report,
    parse_operator, segment_ops,
)
from repro_torch.telemetry.critical_path import (  # noqa: F401
    SEGMENTS, SLO, CriticalPathAnalysis, RequestBreakdown, analyze,
    record_goodput, slo_report, triage,
)
from repro_torch.telemetry.metrics import (  # noqa: F401
    LatencySummary, RequestTiming, percentile, percentiles, summarize,
)
from repro_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, exponential_buckets,
)
from repro_torch.telemetry.spans import Span, SpanRecorder  # noqa: F401
from repro_torch.telemetry.tracing import (  # noqa: F401
    RequestTrace, RequestTracer, TraceEvent,
)

_LAZY = ("CharacterizationResult", "MeasuredPoint", "TPSweepPoint",
         "characterize",
         "classify_measured_sweep", "memory_pressure_sweep", "run_point",
         "tp_sweep")


def __getattr__(name):
    if name == "BoundednessMonitor":
        return importlib.import_module(
            "repro_torch.telemetry.monitor").BoundednessMonitor
    if name in _LAZY:
        mod = importlib.import_module("repro_torch.telemetry.characterize")
        return mod if name == "characterize" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
