"""Per-request timings and percentiles.

Copy of the parts of ``repro/telemetry/metrics.py`` the port's engine and
serve launcher use: ``RequestTiming`` (lifecycle timestamps on the engine
clock) and ``percentile`` (linear interpolation, numpy's default).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """q-th percentile (0..100), linear interpolation (numpy default)."""
    if not values:
        return float("nan")
    s = sorted(values)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return float(s[lo])
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


@dataclass
class RequestTiming:
    """Lifecycle timestamps of one request, all on the engine clock."""
    rid: int
    arrival_s: float
    first_token_s: float = float("nan")
    done_s: float = float("nan")
    token_times_s: list = field(default_factory=list)  # incl. first token

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def itl_s(self) -> list:
        """Inter-token latencies (gaps between consecutive tokens)."""
        ts = self.token_times_s
        return [b - a for a, b in zip(ts, ts[1:])]
