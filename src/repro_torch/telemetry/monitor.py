"""Online CPU/GPU-boundedness monitor over the live dispatch stream.

Copy of ``repro/telemetry/monitor.py``.

``launch.characterize`` classifies boundedness *offline* by sweeping
batch sizes; serving can't do that — the batch it runs at is whatever
continuous batching produced this step.  The monitor instead buckets
every decode step by its live batch size, keeps a sliding window of
(step time, launch tax) per bucket, and reruns the same inflection rule
(``core.boundedness`` via ``classify_measured_sweep``) over the bucket
means, so the CPU-bound/GPU-bound verdict — and the transition batch —
updates continuously during ``ServeEngine.run()``.

Per-operator TKLQT totals (fed from the attribution layer once per
planned decode call) ride along, so the verdict comes with a ranked
"who is paying the launch tax" answer — the hook the ROADMAP's
SLO-aware router consumes.
"""
from __future__ import annotations

from collections import deque

from repro_torch.core.boundedness import INFLECTION_FACTOR, BoundednessResult
from repro_torch.telemetry.characterize import classify_measured_sweep


class BoundednessMonitor:
    """Sliding-window boundedness estimator keyed by live batch size."""

    def __init__(self, window: int = 64,
                 factor: float = INFLECTION_FACTOR,
                 refresh_stride: int = 16):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if refresh_stride < 1:
            raise ValueError(
                f"refresh_stride must be >= 1, got {refresh_stride}")
        self.window = window
        self.factor = factor
        # bound gauges republish every Nth observation (scrape-time
        # views tolerate a few steps of lag; reclassifying the whole
        # sweep per decode step would eat the <5% telemetry budget) —
        # any result()/verdict()/summary() call republishes immediately
        self.refresh_stride = refresh_stride
        self._pending = 0
        self._buckets: dict = {}          # batch -> deque[(step_s, tax_s)]
        self._op_totals: dict = {}        # operator -> [launches, tklqt_s]
        self._registry = None
        self._g_inflection = None
        self._g_bound = None
        self._g_step = None
        self._c_op_tklqt = None
        self._c_op_launch = None

    # ------------------------------------------------------------ wiring
    def bind_metrics(self, registry) -> None:
        self._registry = registry
        self._g_inflection = registry.gauge(
            "monitor_inflection_batch",
            "live CPU->GPU-bound transition batch (-1 = none observed)")
        self._g_bound = registry.gauge(
            "monitor_gpu_bound",
            "1 = this batch bucket classifies GPU-bound, 0 = CPU-bound",
            labels=("batch",))
        self._g_step = registry.gauge(
            "monitor_window_step_seconds",
            "sliding-window mean decode-step time per batch bucket",
            labels=("batch",))
        self._c_op_tklqt = registry.counter(
            "monitor_operator_tklqt_seconds_total",
            "attributed launch+queue time per model operator",
            labels=("operator",))
        self._c_op_launch = registry.counter(
            "monitor_operator_launches_total",
            "attributed kernel launches per model operator",
            labels=("operator",))

    # ------------------------------------------------------------ feeding
    def observe(self, batch: int, step_s: float, tax_s: float = 0.0) -> None:
        """One decode step at live ``batch`` took ``step_s`` of which
        ``tax_s`` was host-side dispatch."""
        if batch < 1:
            return
        dq = self._buckets.get(batch)
        if dq is None:
            dq = self._buckets[batch] = deque(maxlen=self.window)
        dq.append((step_s, tax_s))
        if self._registry is not None:
            self._pending += 1
            if self._pending >= self.refresh_stride:
                self._refresh_gauges()

    def observe_operators(self, rows, calls: int = 1) -> None:
        """Accumulate per-operator attribution rows (OperatorRow-like:
        .operator/.launches/.tklqt_s) for ``calls`` identical calls."""
        for r in rows:
            acc = self._op_totals.get(r.operator)
            if acc is None:
                acc = self._op_totals[r.operator] = [0.0, 0.0]
            launches = float(r.launches) * calls
            tklqt = r.tklqt_s * calls
            acc[0] += launches
            acc[1] += tklqt
            if self._c_op_tklqt is not None:
                self._c_op_tklqt.inc(tklqt, operator=r.operator)
                self._c_op_launch.inc(launches, operator=r.operator)

    # ------------------------------------------------------------ verdicts
    def result(self) -> BoundednessResult:
        """Classify the current windows with the offline sweep rule."""
        batches = sorted(self._buckets)
        steps, taxes = [], []
        for b in batches:
            dq = self._buckets[b]
            steps.append(sum(s for s, _ in dq) / len(dq))
            taxes.append(sum(t for _, t in dq) / len(dq))
        res = classify_measured_sweep(batches, steps, taxes)
        if self._g_inflection is not None:
            self._publish(res)
        return res

    def verdict(self, batch: int = None) -> str:
        res = self.result()
        if not res.batches:
            return "unknown"
        if batch is None:
            batch = res.batches[-1]
        return res.classify(batch)

    def top_operators(self, k: int = 5) -> list:
        """[(operator, launches, tklqt_s)] ranked by attributed TKLQT."""
        ranked = sorted(self._op_totals.items(), key=lambda kv: -kv[1][1])
        return [(op, v[0], v[1]) for op, v in ranked[:k]]

    def summary(self) -> dict:
        res = self.result()
        return {
            "batches": res.batches,
            "window_mean_step_s": res.tklqt,
            "queue_share": res.queue_share,
            "inflection_batch": res.inflection_batch,
            "classification": {str(b): res.classify(b)
                               for b in res.batches},
            "top_operators": [
                {"operator": op, "launches": launches,
                 "tklqt_us": tklqt * 1e6}
                for op, launches, tklqt in self.top_operators()
            ],
        }

    def clear(self) -> None:
        self._buckets.clear()
        self._op_totals.clear()

    # ------------------------------------------------------------ internals
    def _refresh_gauges(self) -> None:
        self.result()                      # result() publishes when bound

    def _publish(self, res: BoundednessResult) -> None:
        self._pending = 0
        self._g_inflection.set(
            -1 if res.inflection_batch is None else res.inflection_batch)
        for b, t in zip(res.batches, res.tklqt):
            self._g_step.set(t, batch=b)
            self._g_bound.set(
                1.0 if res.classify(b) == "GPU-bound" else 0.0, batch=b)
