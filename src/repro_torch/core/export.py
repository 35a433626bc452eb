"""Chrome-trace (chrome://tracing / Perfetto) export of SKIP timelines —
host lane (launch calls) + device lane (kernel execution), so the
CPU-bound launch trains and GPU-bound queue pileups of the paper's Fig. 4
are visually inspectable.

Copy of ``repro/core/export.py`` but its request traces, which come with
request tracing (ROADMAP Queue A, "fleet, router, request tracing"): the
modeled timeline of one call (``to_chrome_trace``) and the merged
timeline of a measured run (``merged_chrome_trace``: the engine's
measured host spans over the modeled device lane).  Files are written as
strict JSON (no NaN or Infinity), which Perfetto and ``json.loads`` both
read.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

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
        json.dump(to_chrome_trace(events, platform), f, allow_nan=False)
    return path


# --------------------------------------------------------------- measured
def spans_to_chrome_events(spans, pid: int = 0) -> list:
    """Telemetry spans (``repro_torch.telemetry.spans.Span``) -> chrome
    trace events."""
    out = []
    for s in spans:
        ev = {
            "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
            "ts": s.t0 * 1e6, "dur": max(s.dur * 1e6, 0.01),
            "cat": s.cat,
        }
        if s.args:
            ev["args"] = dict(s.args)
        out.append(ev)
    return out


def merged_chrome_trace(spans, platform: str,
                        device_events: Sequence[KernelEvent] = (),
                        device_anchors: Sequence[float] = (),
                        device_tid: int = 2,
                        metadata: Optional[dict] = None) -> dict:
    """Merged timeline: MEASURED host spans + MODELED device kernels.

    ``device_events`` is one modeled invocation (e.g. the planner's
    simulated decode step); it is replicated at each ``device_anchors``
    offset (seconds) — typically the measured start of every decode step —
    so the modeled device lane lines up under the real host lane.  Each
    (anchor, event) pair gets one flow arrow with its own id.
    """
    out = spans_to_chrome_events(spans)
    n_ev = len(device_events)
    for ai, anchor in enumerate(device_anchors):
        for i, e in enumerate(device_events):
            args = {"t_l_us": e.t_l * 1e6}
            if getattr(e, "operator", ""):
                args["operator"] = e.operator
            out.append({
                "name": e.name, "ph": "X", "pid": 0, "tid": device_tid,
                "ts": (anchor + e.kernel_start) * 1e6,
                "dur": max(e.duration * 1e6, 0.01),
                "cat": "modeled_kernel",
                "args": args,
            })
            # arrow from the modeled host-issue instant (within the
            # measured segment-dispatch lane) to the modeled kernel
            out.extend(_flow_pair(e.name, ai * n_ev + i,
                                  (anchor + e.launch_begin) * 1e6,
                                  (anchor + e.kernel_start) * 1e6,
                                  1, device_tid))
    meta = {"platform": platform}
    if metadata:
        meta.update(metadata)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": meta,
        "otherData": {
            "thread_names": {
                "0": "CPU host (engine steps)",
                "1": "CPU host (segment dispatches)",
                str(device_tid): f"{platform} stream 0 (modeled)",
            },
        },
    }


def save_merged_trace(spans, platform: str, path: str, *,
                      device_events: Sequence[KernelEvent] = (),
                      device_anchors: Sequence[float] = (),
                      metadata: Optional[dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(merged_chrome_trace(spans, platform,
                                      device_events=device_events,
                                      device_anchors=device_anchors,
                                      metadata=metadata), f,
                  allow_nan=False)
    return path
