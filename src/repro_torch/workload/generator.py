"""Seeded workload generation: Scenario -> concrete request list.

Copy of ``repro/workload/generator.py`` (the same ``numpy`` draws in the
same order, so both packages generate the same requests).

Everything downstream (engine runs, telemetry, boundedness sweeps) is a
pure function of the generated requests, so determinism here — one
``numpy`` Generator seeded from ``(seed)``, sampled in a fixed order —
makes whole characterization runs reproducible and replayable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.workload.scenarios import Scenario, get_scenario


@dataclass
class WorkloadRequest:
    """One generated request: arrival offset + prompt + decode budget."""
    rid: int
    arrival_s: float
    prompt: list                    # token ids
    max_new_tokens: int

    def to_json(self) -> dict:
        return {"rid": self.rid, "arrival_s": self.arrival_s,
                "prompt": list(self.prompt),
                "max_new_tokens": self.max_new_tokens}

    @classmethod
    def from_json(cls, d: dict) -> "WorkloadRequest":
        return cls(rid=int(d["rid"]), arrival_s=float(d["arrival_s"]),
                   prompt=[int(t) for t in d["prompt"]],
                   max_new_tokens=int(d["max_new_tokens"]))


@dataclass
class Workload:
    scenario: str
    seed: int
    vocab_size: int
    requests: list = field(default_factory=list)  # list[WorkloadRequest]

    @property
    def n(self) -> int:
        return len(self.requests)

    def meta(self) -> dict:
        return {"schema": 1, "scenario": self.scenario, "seed": self.seed,
                "vocab_size": self.vocab_size, "n_requests": self.n}


def _arrivals(scenario: Scenario, n: int, rng, time_scale: float) -> list:
    if scenario.arrival == "closed":
        return [0.0] * n
    # time_scale > 1 compresses the timeline: arrivals come time_scale x
    # faster and bursty on/off windows shrink by the same factor
    rate = scenario.rate_rps * time_scale
    gaps = rng.exponential(1.0 / rate, size=n)
    ts = np.cumsum(gaps)
    if scenario.arrival == "bursty":
        # on/off modulation: traffic generated at `rate` fills burst_s-long
        # windows; each completed window pushes later arrivals past idle_s
        burst = scenario.burst_s / time_scale
        idle = scenario.idle_s / time_scale
        ts = ts + np.floor(ts / burst) * idle
    return [float(round(t, 6)) for t in ts]


def sample_requests(scenario, n_requests: int, *, seed: int = 0,
                    vocab_size: int = 503,
                    prompt_cap: Optional[int] = None,
                    output_cap: Optional[int] = None,
                    time_scale: float = 1.0,
                    shared_prefix: int = 0) -> Workload:
    """Generate a deterministic request list for ``scenario``.

    prompt_cap/output_cap clip the scenario's length distributions (so a
    long-prefill scenario stays tractable on a reduced model);
    time_scale > 1 compresses the arrival timeline by that factor;
    shared_prefix > 0 prepends the SAME sampled system prompt of that
    many tokens to every request (prefix-affinity routing and engine
    prefix sharing then see one common key).  prompt_cap applies to the
    per-request tail, so the shared head is never clipped away.
    """
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    if not time_scale > 0:
        raise ValueError(f"time_scale must be > 0, got {time_scale}")
    if shared_prefix < 0:
        raise ValueError(f"shared_prefix must be >= 0, got {shared_prefix}")
    rng = np.random.default_rng(seed)
    # sampled FIRST (only when requested) so shared_prefix=0 workloads
    # stay byte-identical to pre-option streams
    head = ([int(t) for t in rng.integers(0, vocab_size, size=shared_prefix)]
            if shared_prefix else [])
    arrivals = _arrivals(scenario, n_requests, rng, time_scale)
    reqs = []
    for i in range(n_requests):
        plen = scenario.prompt.sample(rng)
        olen = scenario.output.sample(rng)
        if prompt_cap:
            plen = min(plen, prompt_cap)
        if output_cap:
            olen = min(olen, output_cap)
        prompt = head + [int(t)
                         for t in rng.integers(0, vocab_size, size=plen)]
        reqs.append(WorkloadRequest(rid=i, arrival_s=arrivals[i],
                                    prompt=prompt, max_new_tokens=max(olen, 1)))
    name = scenario.name
    return Workload(scenario=name, seed=seed, vocab_size=vocab_size,
                    requests=reqs)
