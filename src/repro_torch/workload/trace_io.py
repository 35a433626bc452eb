"""JSONL workload trace record/replay.

Copy of ``repro/workload/trace_io.py``.

File format: line 1 is a meta header (schema/scenario/seed/...), every
following line is one request.  All lines are canonical JSON
(sorted keys, no whitespace), so ``save(load(path)) == bytes(path)`` —
the round-trip is byte-identical and a trace file is a stable artifact
that fully reproduces a characterization run's traffic.
"""
from __future__ import annotations

import json

from repro_torch.workload.generator import Workload, WorkloadRequest


def _canon(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def save_workload(workload: Workload, path: str) -> str:
    lines = [_canon(workload.meta())]
    lines += [_canon(r.to_json()) for r in workload.requests]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def load_workload(path: str) -> Workload:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"empty workload trace: {path}")
    meta = json.loads(lines[0])
    if meta.get("schema") != 1:
        raise ValueError(f"unsupported workload trace schema in {path}: "
                         f"{meta.get('schema')!r}")
    reqs = [WorkloadRequest.from_json(json.loads(ln)) for ln in lines[1:]]
    if len(reqs) != meta.get("n_requests", len(reqs)):
        raise ValueError(
            f"trace {path} header claims {meta['n_requests']} requests, "
            f"found {len(reqs)}")
    return Workload(scenario=meta["scenario"], seed=meta["seed"],
                    vocab_size=meta["vocab_size"], requests=reqs)
