"""Metrics registry: labeled Counter/Gauge/Histogram + Prometheus export.

The registry is the single live store serving telemetry writes into —
``EngineStats`` scalars delegate here, backends/pools/monitors register
their own families — and reads come out two ways: ``snapshot()`` (a
plain-JSON dict for artifacts and tests) and ``to_prometheus()`` (the
text exposition format, so ``serve --metrics-out metrics.prom`` drops a
scrape-ready file).

Design constraints, in order: recording must be allocation-light (one
dict lookup + float add per observation — it sits on the decode hot
path, gated by the <5% bench budget), label handling must be strict
(every call names the full label set its family declared, so snapshots
never grow surprise series), and histograms use fixed exponential
buckets (latency spans decades; ITL/TTFT/step-time families share the
same default grid so their distributions compare bucket-for-bucket).
"""
from __future__ import annotations

import math
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

    def add(self, amount: float, **labels) -> None:
        """Shift the labeled series by ``amount`` (either sign)."""
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

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

    def count(self, **labels) -> int:
        """Total observations recorded for the labeled series."""
        return self._totals.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        """Sum of all observed values for the labeled series."""
        return self._sums.get(self._key(labels), 0.0)

    def quantile(self, q: float, **labels) -> float:
        """Bucket-resolution quantile estimate (upper bound of the
        bucket holding the q-th observation; math.inf when it landed
        in the overflow bucket, 0.0 when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        key = self._key(labels)
        total = self._totals.get(key, 0)
        if not total:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(self._counts[key]):
            seen += c
            if seen >= rank and c:
                return (self.bounds[i] if i < len(self.bounds)
                        else math.inf)
        return math.inf

    def merge_series(self, count: int, sum: float, buckets,
                     **labels) -> None:
        """Fold an already-bucketed series (another registry's snapshot
        of a same-bounds family) into the labeled series — the fleet
        aggregation path, where re-observing raw values is impossible."""
        if len(buckets) != len(self.bounds) + 1:
            raise ValueError(
                f"histogram {self.name!r} has {len(self.bounds) + 1} "
                f"buckets (incl. overflow), got {len(buckets)}")
        key = self._key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.bounds) + 1)
            self._sums[key] = 0.0
            self._totals[key] = 0
        for i, c in enumerate(buckets):
            counts[i] += c
        self._sums[key] += sum
        self._totals[key] += count

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

    def get(self, name: str):
        """The named family, or None."""
        return self._families.get(name)

    def names(self) -> list:
        """Family names in registration order."""
        return list(self._families)

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

    def to_prometheus(self) -> str:
        """Text exposition format (counters get a _total suffix only if
        the family name already carries one — names here are explicit)."""
        lines = []
        for name, fam in self._families.items():
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            if fam.kind == "histogram":
                for key, s in fam.series().items():
                    base = _label_str(fam.label_names, key)
                    cum = 0
                    for b, c in zip(fam.bounds, s["buckets"]):
                        cum += c
                        lines.append(
                            f"{name}_bucket{_merge(base, _fmt(b))} "
                            f"{cum}")
                    cum += s["buckets"][-1]
                    lines.append(
                        f"{name}_bucket{_merge(base, '+Inf')}"
                        f" {cum}")
                    lines.append(f"{name}_sum{_wrap(base)} {_fmt(s['sum'])}")
                    lines.append(f"{name}_count{_wrap(base)} {s['count']}")
            else:
                for key, val in fam.series().items():
                    base = _label_str(fam.label_names, key)
                    lines.append(f"{name}{_wrap(base)} {_fmt(val)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Prometheus-safe number formatting (ints bare, +/-Inf named)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def _escape_label_value(v: str) -> str:
    """Escape a label value per the Prometheus text-exposition spec:
    backslash, double-quote, and newline must be backslash-escaped
    (order matters — backslash first, or the others double-escape)."""
    return (v.replace("\\", "\\\\")
             .replace('"', '\\"')
             .replace("\n", "\\n"))


def _label_str(names, key) -> str:
    """Render a label set as name="value" pairs (values escaped)."""
    return ",".join(f'{n}="{_escape_label_value(v)}"'
                    for n, v in zip(names, key))


def _wrap(base: str) -> str:
    """Brace a label string, or nothing when unlabeled."""
    return f"{{{base}}}" if base else ""


def _merge(base: str, le_value: str) -> str:
    """Brace a label string with the histogram ``le=`` pair appended."""
    extra = f'le="{_escape_label_value(le_value)}"'
    return f"{{{base},{extra}}}" if base else f"{{{extra}}}"
