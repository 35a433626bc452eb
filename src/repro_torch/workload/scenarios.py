"""Scenario registry: named serving-traffic shapes.

Copy of ``repro/workload/scenarios.py``.

The boundedness story of the paper (and of "Characterizing CPU-Induced
Slowdowns in Multi-GPU LLM Inference") depends on traffic shape: arrival
rate, prompt/output length mix, and burstiness move the CPU/GPU-bound
crossover.  A ``Scenario`` captures one such shape declaratively —
an arrival process plus prompt/output length distributions — and the
registry gives them stable names so a characterization run is fully
described by ``(scenario, seed, n_requests)``.

Arrival processes:

  poisson      open loop, exponential inter-arrivals at ``rate_rps``
  closed       closed loop: all requests available at t=0, concurrency
               is bounded by the engine's slot pool
  bursty       on/off-modulated Poisson: ``burst_s`` of ``rate_rps``
               traffic, then ``idle_s`` of silence, repeating
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

ARRIVALS = ("poisson", "closed", "bursty")


@dataclass(frozen=True)
class LengthDist:
    """Integer length distribution: fixed | uniform | lognormal (clipped)."""
    kind: str                       # fixed | uniform | lognormal
    lo: int                         # fixed value, or clip floor
    hi: Optional[int] = None        # clip ceiling (uniform/lognormal)
    sigma: float = 0.5              # lognormal shape (median = lo..hi midpoint)

    def sample(self, rng) -> int:
        if self.kind == "fixed":
            return int(self.lo)
        if self.kind == "uniform":
            return int(rng.integers(self.lo, self.hi + 1))
        if self.kind == "lognormal":
            median = (self.lo + self.hi) / 2.0
            v = rng.lognormal(0.0, self.sigma) * median
            return int(min(max(round(v), self.lo), self.hi))
        raise ValueError(f"unknown length distribution kind {self.kind!r}")


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    arrival: str                    # poisson | closed | bursty
    prompt: LengthDist
    output: LengthDist
    rate_rps: float = 0.0           # poisson/bursty mean arrival rate
    burst_s: float = 0.0            # bursty: length of an on-phase
    idle_s: float = 0.0             # bursty: silence between bursts
    # default latency SLOs for goodput accounting (None = unconstrained);
    # CLI --slo-ttft-ms/--slo-itl-ms override per run
    slo_ttft_s: Optional[float] = None
    slo_itl_s: Optional[float] = None

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival process {self.arrival!r}; "
                             f"expected one of {ARRIVALS}")
        if self.arrival in ("poisson", "bursty") and not self.rate_rps > 0:
            raise ValueError(f"{self.arrival!r} arrivals need rate_rps > 0, "
                             f"got {self.rate_rps}")
        if self.arrival == "bursty":
            if not self.burst_s > 0:
                raise ValueError("bursty arrivals need burst_s > 0, "
                                 f"got {self.burst_s}")
            if self.idle_s < 0:
                raise ValueError(f"idle_s must be >= 0, got {self.idle_s}")


_SCENARIOS: dict[str, Scenario] = {}


def register_scenario(s: Scenario) -> Scenario:
    _SCENARIOS[s.name] = s
    return s


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(_SCENARIOS)}") from None


def list_scenarios() -> list[str]:
    return sorted(_SCENARIOS)


# ------------------------------------------------------------ catalog
# Length scales are in tokens and deliberately modest so reduced-model CPU
# runs stay fast; the generator's prompt_cap/output_cap clip them further.
register_scenario(Scenario(
    name="chatbot",
    description="interactive chat: open-loop Poisson arrivals, "
                "medium prompts, medium decode-heavy outputs",
    arrival="poisson", rate_rps=4.0,
    prompt=LengthDist("lognormal", lo=8, hi=64, sigma=0.4),
    output=LengthDist("lognormal", lo=8, hi=48, sigma=0.4),
    slo_ttft_s=0.2, slo_itl_s=0.05,
))
register_scenario(Scenario(
    name="code-completion",
    description="IDE completions: closed loop (editor waits), larger "
                "context prompts, short outputs",
    arrival="closed",
    prompt=LengthDist("lognormal", lo=24, hi=128, sigma=0.3),
    output=LengthDist("uniform", lo=4, hi=16),
    slo_ttft_s=0.5, slo_itl_s=0.05,
))
register_scenario(Scenario(
    name="summarization",
    description="long-prefill summarization: closed loop, long prompts, "
                "short outputs — prefill-dominated",
    arrival="closed",
    prompt=LengthDist("uniform", lo=96, hi=256),
    output=LengthDist("uniform", lo=4, hi=12),
    slo_ttft_s=2.0, slo_itl_s=0.1,
))
register_scenario(Scenario(
    name="agentic",
    description="bursty agent loops: on/off Poisson bursts of tool-call "
                "turns, short prompts and outputs",
    arrival="bursty", rate_rps=8.0, burst_s=1.0, idle_s=3.0,
    prompt=LengthDist("uniform", lo=8, hi=32),
    output=LengthDist("uniform", lo=4, hi=12),
    slo_ttft_s=0.3, slo_itl_s=0.05,
))
