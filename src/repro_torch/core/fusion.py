"""Chain fusion — thin facade over the launch-plan runtime.

Copy of ``repro/core/fusion.py``.  Takes proximity-score recommendations,
builds a chain ``LaunchPlan``, and runs both it and the eager plan through
``repro_torch.runtime.PlanExecutor`` (both dispatched directly: the
measured difference is the host cost of the segments' dispatch).
Reports measured dispatch counts and host time against eager, plus the
paper's idealized Eq. 8 speedup for comparison.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.proximity import mine_chains
from repro_torch.core.tracing import Trace


def json_safe(value):
    """JSON-exportable number: finite floats pass through, ``inf``/``nan``
    become their string names.  Python's ``json`` would otherwise emit
    bare ``Infinity``/``NaN`` tokens, which are NOT valid JSON and break
    strict parsers reading exported reports."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def json_sanitize(obj):
    """Recursive ``json_safe``: walk dicts/lists/tuples and sanitize every
    leaf, so whole report payloads (bench artifacts, serve CLI JSON) can be
    dumped with ``allow_nan=False`` — the shared strict-JSON export path."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    return json_safe(obj)


@dataclass
class FusionOutcome:
    length: int
    k_eager: int
    k_fused: int                   # Eq. 7 (and actual launch count)
    ideal_speedup: float           # Eq. 8
    eager_host_s: float            # measured host dispatch total
    fused_host_s: float
    measured_speedup: float        # eager host / fused host
    max_abs_err: float             # fused vs eager outputs

    def row(self) -> dict:
        """JSON-safe export dict: ``measured_speedup`` can be ``inf``
        (0-cost fused time) or ``nan`` (0/0) by design — see
        ``_speedup`` — so export paths must go through here."""
        return {
            "length": self.length,
            "k_eager": self.k_eager,
            "k_fused": self.k_fused,
            "ideal_speedup": json_safe(self.ideal_speedup),
            "eager_host_us": round(self.eager_host_s * 1e6, 3),
            "fused_host_us": round(self.fused_host_s * 1e6, 3),
            "measured_speedup": json_safe(self.measured_speedup),
            "max_abs_err": json_safe(self.max_abs_err),
        }


def _speedup(eager_host: float, fused_host: float) -> float:
    """eager/fused with degenerate guards: 0-cost fused time on a nonzero
    eager baseline is an infinite speedup, and 0/0 is undefined — neither
    should silently report 0.0 (i.e. a slowdown)."""
    if fused_host > 0.0:
        return eager_host / fused_host
    return float("inf") if eager_host > 0.0 else float("nan")


def apply_fusion(trace: Trace, *args, length: int = 8,
                 repeats: int = 3) -> FusionOutcome:
    from repro_torch.runtime.executor import PlanExecutor
    from repro_torch.runtime.plan import LaunchPlan

    names = trace.kernel_names
    mining = mine_chains(names, length, threshold=1.0)

    eager = PlanExecutor(trace, LaunchPlan.eager(len(names)))
    fused = PlanExecutor(trace, LaunchPlan.chain(names, length,
                                                 mining=mining))

    t_e = eager.measure_host(*args, repeats=repeats)
    t_f = fused.measure_host(*args, repeats=repeats)

    out_e, _ = eager.run(*args)
    out_f, _ = fused.run(*args)
    err = 0.0
    for a, b in zip(out_e, out_f):
        if isinstance(a, torch.Tensor):
            err = max(err, (a.double() - b.double()).abs().max().item())

    eager_host = sum(t_e)
    fused_host = sum(t_f)
    return FusionOutcome(
        length=length, k_eager=mining.k_eager, k_fused=fused.n_launches,
        ideal_speedup=mining.speedup,
        eager_host_s=eager_host, fused_host_s=fused_host,
        measured_speedup=_speedup(eager_host, fused_host),
        max_abs_err=err)
