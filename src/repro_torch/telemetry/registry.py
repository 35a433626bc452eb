"""Metrics registry: labeled Counter/Gauge/Histogram.

Copy of ``repro/telemetry/registry.py`` without the Prometheus exporter
and the fleet merge path, which the port's engine does not use yet.  The
registry is the single live store serving telemetry writes into:
``EngineStats`` scalars delegate here, backends register their own
families, and ``snapshot()`` reads it out as plain JSON.

Design constraints, in order: recording must be allocation-light (one
dict lookup + float add per observation — it sits on the decode hot
path, gated by the <5% bench budget), label handling must be strict
(every call names the full label set its family declared, so snapshots
never grow surprise series), and histograms use fixed exponential
buckets (latency spans decades; ITL/TTFT/step-time families share the
same default grid so their distributions compare bucket-for-bucket).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence


def exponential_buckets(start: float, factor: float,
                        count: int) -> tuple:
    """``count`` bucket upper bounds: start, start*factor, ... (the
    +Inf bucket is implicit in every histogram)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"need start > 0, factor > 1, count >= 1; got "
            f"({start}, {factor}, {count})")
    return tuple(start * factor ** i for i in range(count))


# 1us .. ~67s in doublings: wide enough for per-segment dispatch times at
# the bottom and cold-compile TTFTs at the top
DEFAULT_TIME_BUCKETS = exponential_buckets(1e-6, 2.0, 27)


class _Family:
    """Shared label plumbing for one named metric family."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)

    def _key(self, labels: dict) -> tuple:
        """Series key from kwargs; the FULL declared label set is
        required — partial or extra labels are registration bugs."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} declared labels "
                f"{self.label_names}, got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)


class Counter(_Family):
    """Monotonic accumulator (counts, bytes, seconds-of-tax)."""

    kind = "counter"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._values: dict = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (>= 0) to the labeled series."""
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc {amount})")
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        """Current accumulated value of the labeled series (0 if unseen)."""
        return self._values.get(self._key(labels), 0.0)

    def series(self) -> dict:
        """All series as {label-value tuple: value}."""
        return dict(self._values)


class Gauge(_Family):
    """Set-to-current-value metric (utilization, verdicts, levels)."""

    kind = "gauge"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._values: dict = {}

    def set(self, value: float, **labels) -> None:
        """Overwrite the labeled series with ``value``."""
        self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        """Current value of the labeled series (0 if never set)."""
        return self._values.get(self._key(labels), 0.0)

    def series(self) -> dict:
        """All series as {label-value tuple: value}."""
        return dict(self._values)


class Histogram(_Family):
    """Fixed-bucket distribution (cumulative counts, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name, help="", labels=(),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labels)
        bounds = tuple(buckets if buckets is not None
                       else DEFAULT_TIME_BUCKETS)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"histogram {self.name!r} buckets must be strictly "
                f"increasing: {bounds}")
        self.bounds = bounds
        self._counts: dict = {}    # key -> [per-bucket counts] + overflow
        self._sums: dict = {}
        self._totals: dict = {}

    def observe(self, value: float, **labels) -> None:
        """Record one observation into its bucket (linear scan)."""
        key = self._key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.bounds) + 1)
            self._sums[key] = 0.0
            self._totals[key] = 0
        # linear scan is fine: bucket lists are ~27 long and most
        # observations land in the first few buckets (µs-scale times)
        for i, b in enumerate(self.bounds):
            if value <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[key] += value
        self._totals[key] += 1

    def series(self) -> dict:
        """All series as {key: {count, sum, buckets}}."""
        out = {}
        for key, counts in self._counts.items():
            out[key] = {
                "count": self._totals[key],
                "sum": self._sums[key],
                "buckets": list(counts),
            }
        return out


class MetricsRegistry:
    """Ordered name -> family store with get-or-create accessors."""

    def __init__(self):
        self._families: OrderedDict = OrderedDict()

    def _get_or_create(self, cls, name, help, labels, **kw):
        """Return the named family, creating it on first registration;
        re-registering under a different kind is a TypeError."""
        fam = self._families.get(name)
        if fam is not None:
            if not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{fam.kind}, requested {cls.kind}")
            return fam
        fam = cls(name, help=help, labels=labels, **kw)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        """Get-or-create a Counter family."""
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        """Get-or-create a Gauge family."""
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create a Histogram family (default time buckets)."""
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """Plain-JSON view: family -> {type, help, labels, series}."""
        out = {}
        for name, fam in self._families.items():
            series = []
            for key, val in fam.series().items():
                series.append({
                    "labels": dict(zip(fam.label_names, key)),
                    "value": val,
                })
            out[name] = {
                "type": fam.kind,
                "help": fam.help,
                "label_names": list(fam.label_names),
                "series": series,
            }
            if fam.kind == "histogram":
                out[name]["buckets"] = list(fam.bounds)
        return out
