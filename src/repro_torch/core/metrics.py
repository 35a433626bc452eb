"""SKIP metrics (paper Eqs. 1-5) over a simulated or measured timeline.

Copy of ``repro/core/metrics.py``.  The events are modeled
(``core.device_model.simulate``, ``runtime.planner.simulate_plan``) or, on
the card, measured from ``torch.profiler`` (``chip_smoke.py`` phase 12).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.device_model import KernelEvent


@dataclass
class SkipReport:
    platform: str
    n_kernels: int
    tklqt: float                  # Eq. 2: sum of launch+queue times
    akd: float                    # Eq. 3: average kernel duration
    il: float                     # Eq. 4: inference latency
    gpu_idle: float               # Eq. 5: IL - sum kernel durations
    cpu_idle: float               # IL - host busy time
    queue_share: float            # fraction of TKLQT that is queuing
    top_k: list                   # [(kernel name, count, total launch tax)]

    def row(self) -> dict:
        return {
            "platform": self.platform, "n_kernels": self.n_kernels,
            "tklqt_us": self.tklqt * 1e6, "akd_us": self.akd * 1e6,
            "il_us": self.il * 1e6, "gpu_idle_us": self.gpu_idle * 1e6,
            "cpu_idle_us": self.cpu_idle * 1e6,
            "queue_share": self.queue_share,
        }


def report(events: Sequence[KernelEvent], platform: str,
           launch_overhead_s: float, k: int = 5) -> SkipReport:
    n = len(events)
    tklqt = sum(e.t_l for e in events)                       # Eq. 2
    durs = sum(e.duration for e in events)
    akd = durs / n if n else 0.0                             # Eq. 3
    il = (events[-1].kernel_end - events[0].launch_begin) if n else 0.0  # Eq. 4
    gpu_idle = il - durs                                     # Eq. 5
    host_busy = sum(e.t_launch for e in events)
    cpu_idle = max(il - host_busy, 0.0)
    queue = sum(e.t_queue for e in events)
    queue_share = queue / tklqt if tklqt else 0.0

    tax = Counter()
    cnt = Counter()
    for e in events:
        tax[e.name] += e.t_l
        cnt[e.name] += 1
    top = sorted(tax, key=tax.get, reverse=True)[:k]
    top_k = [(name, cnt[name], tax[name]) for name in top]
    return SkipReport(platform, n, tklqt, akd, il, gpu_idle, cpu_idle,
                      queue_share, top_k)
