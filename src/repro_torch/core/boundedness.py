"""PU-boundedness classification from TKLQT-vs-batch curves (paper §V-B).

Copy of ``repro/core/boundedness.py``.

CPU-bound region: TKLQT flat in batch (pure launch overhead, GPU
under-utilized).  GPU-bound: kernel queuing dominates, TKLQT grows.  The
inflection batch size (star markers in Fig. 6) is where TKLQT exceeds the
flat launch-tax level by a threshold factor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

INFLECTION_FACTOR = 1.5


@dataclass
class BoundednessResult:
    batches: list
    tklqt: list                   # per batch
    queue_share: list
    inflection_batch: int | None  # first GPU-bound batch (None = always CPU-bound)

    def classify(self, batch: int) -> str:
        if self.inflection_batch is None or batch < self.inflection_batch:
            return "CPU-bound"
        return "GPU-bound"

    @property
    def cpu_bound_region(self):
        if self.inflection_batch is None:
            return (self.batches[0], self.batches[-1])
        return (self.batches[0], self.inflection_batch)


_BASE_EPS = 1e-12      # below this the flat (launch) level is not established


def find_inflection(batches: Sequence[int], tklqt: Sequence[float],
                    factor: float = INFLECTION_FACTOR):
    """First batch where TKLQT rises above factor x the flat (launch) level.

    Degenerate inputs return None (no inflection) rather than a spurious
    one: a zero/near-zero base level would let ANY positive value trip
    ``t > factor * base``, and mismatched sequence lengths mean the input
    is not a curve at all.
    """
    if not batches or len(batches) != len(tklqt):
        return None
    base = tklqt[0]
    if not (base > _BASE_EPS):        # zero, near-zero, negative, or NaN
        return None
    for b, t in zip(batches, tklqt):
        if t > factor * base:
            return b
    return None


def classify_sweep(batches, reports) -> BoundednessResult:
    t = [r.tklqt for r in reports]
    q = [r.queue_share for r in reports]
    return BoundednessResult(list(batches), t, q, find_inflection(batches, t))
