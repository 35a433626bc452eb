"""Streaming-latency metrics: per-request timings -> TTFT/ITL/E2E percentiles.

Copy of ``repro/telemetry/metrics.py``: ``RequestTiming`` (lifecycle
timestamps on the engine clock), ``percentile`` (linear interpolation,
numpy's default) and the ``LatencySummary`` a measured sweep point carries.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Sequence

PCTS = (50, 95, 99)


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


def percentiles(values: Sequence[float],
                qs: Iterable[int] = PCTS) -> dict:
    return {f"p{q}": percentile(values, q) for q in qs}


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


@dataclass
class LatencySummary:
    n_requests: int
    ttft: dict                     # {"p50": s, "p95": s, "p99": s}
    itl: dict
    e2e: dict
    mean_ttft_s: float
    mean_itl_s: float

    def row(self, unit: float = 1e3) -> dict:
        """Flat dict in milliseconds (unit=1e3) for JSON output."""
        out = {"n_requests": self.n_requests}
        for metric, pcts in (("ttft", self.ttft), ("itl", self.itl),
                             ("e2e", self.e2e)):
            for k, v in pcts.items():
                out[f"{metric}_{k}_ms"] = round(v * unit, 3)
        out["mean_ttft_ms"] = round(self.mean_ttft_s * unit, 3)
        out["mean_itl_ms"] = round(self.mean_itl_s * unit, 3)
        return out


def summarize(timings: Sequence[RequestTiming],
              qs: Iterable[int] = PCTS) -> LatencySummary:
    ttfts = [t.ttft_s for t in timings if not math.isnan(t.ttft_s)]
    e2es = [t.e2e_s for t in timings if not math.isnan(t.e2e_s)]
    itls = [g for t in timings for g in t.itl_s]
    return LatencySummary(
        n_requests=len(timings),
        ttft=percentiles(ttfts, qs),
        itl=percentiles(itls, qs),
        e2e=percentiles(e2es, qs),
        mean_ttft_s=sum(ttfts) / len(ttfts) if ttfts else float("nan"),
        mean_itl_s=sum(itls) / len(itls) if itls else float("nan"),
    )
