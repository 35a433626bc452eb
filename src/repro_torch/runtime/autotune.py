"""Measurement-driven plan autotuner: characterize -> region -> benchmark
-> persisted plan table.

Copy of ``repro/runtime/autotune.py``: the same candidate sets, the same
selection rule and the same plan-table JSON (``PLAN_TABLE_VERSION`` 1), so
a table either package saved loads in the other.  The benchmarks run the
port's engine on ``device`` (``"cuda"`` by default).

This closes the paper's optimization loop over the live serving engine:

1. ``telemetry.characterize.characterize()`` drives the engine with a
   traffic scenario and classifies each batch point CPU- or GPU-bound
   from the MEASURED decode-step curve (``core.boundedness``).
2. In the measured CPU-bound region the bottleneck is host dispatch, so
   the candidate plans are the launch-minimizing family — ``eager`` (the
   baseline), ``chain`` (proximity chains), ``fused`` (rule-substituted
   hand-written kernels).  Whole-graph-style plans are excluded there: the
   paper's Table I compile/capture tax cannot amortize at low batch.
   In the GPU-bound region launches hide behind the device queue, so the
   single-executable family — ``jit``, ``whole_graph`` — competes.
3. Every candidate is benchmarked on the live engine (warmup pass, then
   a measured pass over the same recorded workload) and the fastest
   measured mean decode step wins, ties broken by fewer dispatches.
4. The winners persist as a ``PlanTable`` that
   ``ServeEngine(plan="autotuned", plan_table=...)`` resolves at init —
   the engine serves each slot-pool size with the plan the measurements
   picked for it.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

CPU_BOUND_CANDIDATES = ("eager", "chain", "fused")
GPU_BOUND_CANDIDATES = ("jit", "whole_graph")

# relative step-time band inside which two candidates count as tied and
# the lower dispatch count (the TKLQT-friendly plan) wins
TIE_REL_TOL = 0.02

PLAN_TABLE_VERSION = 1


@dataclass
class CandidateResult:
    """One (batch, plan) cell of the autotune benchmark."""
    plan: str
    mean_decode_step_s: float
    decode_launch_tax_s: float
    dispatches_per_decode_step: float
    fused_dispatches_per_decode_step: float
    tokens_per_s: float
    decode_steps: int

    def row(self) -> dict:
        return {
            "plan": self.plan,
            "mean_decode_step_us": round(self.mean_decode_step_s * 1e6, 1),
            "decode_launch_tax_us": round(self.decode_launch_tax_s * 1e6, 1),
            "dispatches_per_decode_step":
                round(self.dispatches_per_decode_step, 2),
            "fused_dispatches_per_decode_step":
                round(self.fused_dispatches_per_decode_step, 2),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "decode_steps": self.decode_steps,
        }

    @classmethod
    def from_row(cls, row: dict) -> "CandidateResult":
        return cls(
            plan=row["plan"],
            mean_decode_step_s=row["mean_decode_step_us"] * 1e-6,
            decode_launch_tax_s=row["decode_launch_tax_us"] * 1e-6,
            dispatches_per_decode_step=row["dispatches_per_decode_step"],
            fused_dispatches_per_decode_step=row.get(
                "fused_dispatches_per_decode_step", 0.0),
            tokens_per_s=row["tokens_per_s"],
            decode_steps=row["decode_steps"],
        )


@dataclass
class AutotuneEntry:
    batch: int
    region: str                     # "CPU-bound" | "GPU-bound" (measured)
    selected: str
    candidates: list = field(default_factory=list)  # [CandidateResult]

    def row(self) -> dict:
        return {"batch": self.batch, "region": self.region,
                "selected": self.selected,
                "candidates": [c.row() for c in self.candidates]}

    @classmethod
    def from_row(cls, row: dict) -> "AutotuneEntry":
        return cls(batch=row["batch"], region=row["region"],
                   selected=row["selected"],
                   candidates=[CandidateResult.from_row(c)
                               for c in row.get("candidates", [])])


@dataclass
class PlanTable:
    """Persisted (batch -> plan) decisions for one (arch, scenario).

    ``d_model`` pins the measured model's width so a table autotuned on
    a ``reduced()`` toy config (same ``arch`` name!) is never silently
    applied to the full model.
    """
    arch: str
    scenario: str
    platform: str
    d_model: int = 0
    entries: dict = field(default_factory=dict)  # batch -> AutotuneEntry

    def lookup(self, batch: int) -> str:
        """Plan for a slot-pool size: exact entry, else the nearest
        measured batch at or below (the region boundary is monotone in
        batch), else the smallest measured batch."""
        if not self.entries:
            return "auto"
        if batch in self.entries:
            return self.entries[batch].selected
        below = [b for b in self.entries if b <= batch]
        key = max(below) if below else min(self.entries)
        return self.entries[key].selected

    # ------------------------------------------------------------ io
    def to_dict(self) -> dict:
        return {
            "version": PLAN_TABLE_VERSION,
            "arch": self.arch, "scenario": self.scenario,
            "platform": self.platform, "d_model": self.d_model,
            "entries": {str(b): e.row()
                        for b, e in sorted(self.entries.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlanTable":
        version = d.get("version", 0)
        if version != PLAN_TABLE_VERSION:
            raise ValueError(
                f"plan table version {version} != {PLAN_TABLE_VERSION}; "
                "re-run repro_torch.launch.autotune")
        return cls(arch=d.get("arch", ""), scenario=d.get("scenario", ""),
                   platform=d.get("platform", ""),
                   d_model=d.get("d_model", 0),
                   entries={int(b): AutotuneEntry.from_row(e)
                            for b, e in d.get("entries", {}).items()})

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, allow_nan=False)
        return path

    @classmethod
    def load(cls, path: str) -> "PlanTable":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    @classmethod
    def from_any(cls, obj) -> "PlanTable":
        """Coerce a PlanTable, a to_dict() payload, or a file path."""
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls.from_dict(obj)
        if isinstance(obj, (str, os.PathLike)):
            return cls.load(os.fspath(obj))
        raise TypeError(f"cannot build a PlanTable from {type(obj).__name__}")


@dataclass
class AutotuneResult:
    table: PlanTable
    characterization: object       # telemetry CharacterizationResult

    def summary(self) -> dict:
        return {
            "table": self.table.to_dict(),
            "characterization": self.characterization.summary(),
        }


def _candidate_from_point(plan: str, p) -> CandidateResult:
    """CandidateResult from a telemetry ``MeasuredPoint``."""
    return CandidateResult(
        plan=plan,
        mean_decode_step_s=p.mean_decode_step_s,
        decode_launch_tax_s=p.decode_launch_tax_s,
        dispatches_per_decode_step=p.dispatches_per_decode_step,
        fused_dispatches_per_decode_step=p.fused_dispatches_per_decode_step,
        tokens_per_s=p.tokens_per_s,
        decode_steps=p.decode_steps,
    )


def benchmark_plan(cfg, params, workload, *, batch: int, plan: str,
                   platform: str = "Intel+H100",
                   max_len: int = 256, device="cuda") -> CandidateResult:
    """Measure one candidate plan on the live engine (warmup + measure)."""
    from repro_torch.telemetry.characterize import run_point
    p = run_point(cfg, params, workload, batch=batch, plan=plan,
                  platform=platform, max_len=max_len, warmup=True,
                  device=device)
    return _candidate_from_point(plan, p)


def select(candidates: Sequence[CandidateResult],
           tie_rel_tol: float = TIE_REL_TOL) -> str:
    """Fastest measured mean decode step; within ``tie_rel_tol`` of the
    fastest, the lowest dispatch count wins (fewer launches = lower
    TKLQT at equal speed)."""
    if not candidates:
        raise ValueError("no candidates to select from")
    fastest = min(c.mean_decode_step_s for c in candidates)
    near = [c for c in candidates
            if c.mean_decode_step_s <= fastest * (1.0 + tie_rel_tol)]
    near.sort(key=lambda c: (c.dispatches_per_decode_step,
                             c.mean_decode_step_s))
    return near[0].plan


def autotune(cfg, params, *, scenario: str = "chatbot",
             batches: Sequence[int] = (1, 2, 4, 8),
             platform: str = "Intel+H100",
             characterization=None, characterize_plan: str = "eager",
             cpu_candidates: Sequence[str] = CPU_BOUND_CANDIDATES,
             gpu_candidates: Sequence[str] = GPU_BOUND_CANDIDATES,
             n_requests: int = 12, seed: int = 0,
             prompt_cap: Optional[int] = 24, output_cap: Optional[int] = 8,
             time_scale: float = 1.0, max_len: int = 256,
             workload=None, device="cuda") -> AutotuneResult:
    """Characterize, gate candidates by the measured region, benchmark,
    and emit the plan table (see module docstring for the full loop)."""
    from repro_torch.telemetry.characterize import characterize
    if characterization is None:
        characterization = characterize(
            cfg, params, scenario=scenario, batches=batches,
            plan=characterize_plan, platform=platform,
            n_requests=n_requests, seed=seed, prompt_cap=prompt_cap,
            output_cap=output_cap, time_scale=time_scale, max_len=max_len,
            workload=workload, device=device)
    workload = characterization.workload
    by_batch = {p.batch: p for p in characterization.points}

    table = PlanTable(arch=cfg.name, scenario=characterization.scenario,
                      platform=platform, d_model=cfg.d_model)
    for batch in batches:
        region = characterization.boundedness.classify(batch)
        names = cpu_candidates if region == "CPU-bound" else gpu_candidates
        cands = []
        for name in names:
            point = by_batch.get(batch)
            if name == characterization.plan and point is not None:
                # the characterization sweep already measured this plan
                cands.append(_candidate_from_point(name, point))
                continue
            cands.append(benchmark_plan(cfg, params, workload, batch=batch,
                                        plan=name, platform=platform,
                                        max_len=max_len, device=device))
        table.entries[batch] = AutotuneEntry(
            batch=batch, region=region, selected=select(cands),
            candidates=cands)
    return AutotuneResult(table=table, characterization=characterization)
