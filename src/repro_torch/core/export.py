"""Chrome-trace (chrome://tracing / Perfetto) export of SKIP timelines —
host lane (launch calls) + device lane (kernel execution), so the
CPU-bound launch trains and GPU-bound queue pileups of the paper's Fig. 4
are visually inspectable.

Copy of ``to_chrome_trace`` and ``save_chrome_trace`` of
``repro/core/export.py``; the merged and request traces come with the
span recorder (ROADMAP Queue A, "measured characterization and
autotune").
"""
from __future__ import annotations

import json
from typing import Sequence

from repro_torch.core.device_model import KernelEvent


def _flow_pair(name: str, flow_id: int, host_ts_us: float,
               device_ts_us: float, host_tid: int, device_tid: int,
               pid: int = 0) -> list:
    """Chrome-trace flow arrow: a start (``s``) on the host dispatch slice
    and a finish (``f``, binding-point ``e`` = enclosing slice) on the
    device kernel slice, joined by a shared numeric ``id``."""
    return [
        {"name": name, "ph": "s", "pid": pid, "tid": host_tid,
         "ts": host_ts_us, "id": flow_id, "cat": "dispatch_flow"},
        {"name": name, "ph": "f", "pid": pid, "tid": device_tid,
         "ts": device_ts_us, "id": flow_id, "cat": "dispatch_flow",
         "bp": "e"},
    ]


def to_chrome_trace(events: Sequence[KernelEvent], platform: str) -> dict:
    out = []
    for i, e in enumerate(events):
        args = {"t_l_us": e.t_l * 1e6, "queue_us": e.t_queue * 1e6}
        if getattr(e, "operator", ""):
            args["operator"] = e.operator
        out.append({
            "name": e.name, "ph": "X", "pid": 0, "tid": 0,
            "ts": e.launch_begin * 1e6,
            "dur": max(e.t_launch * 1e6, 0.01),
            "cat": "host_launch",
        })
        out.append({
            "name": e.name, "ph": "X", "pid": 0, "tid": 1,
            "ts": e.kernel_start * 1e6,
            "dur": max(e.duration * 1e6, 0.01),
            "cat": "kernel",
            "args": args,
        })
        # arrow from this launch call to the kernel it enqueued: the
        # start event must land INSIDE the host slice, so nudge past
        # launch_begin by a fraction of the (clamped) slice duration
        out.extend(_flow_pair(e.name, i,
                              e.launch_begin * 1e6
                              + 0.5 * max(e.t_launch * 1e6, 0.01),
                              e.kernel_start * 1e6, 0, 1))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": {"platform": platform},
        "otherData": {
            "thread_names": {"0": "CPU (launch calls)",
                             "1": f"{platform} stream 0"},
        },
    }


def save_chrome_trace(events, platform: str, path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events, platform), f)
    return path
