"""Chrome-trace (chrome://tracing / Perfetto) export of SKIP timelines —
host lane (launch calls) + device lane (kernel execution), so the
CPU-bound launch trains and GPU-bound queue pileups of the paper's Fig. 4
are visually inspectable.

Copy of ``repro/core/export.py``: the modeled timeline of one call
(``to_chrome_trace``), the merged timeline of a measured run
(``merged_chrome_trace``: the engine's measured host spans over the
modeled device lane) and the per-request critical paths of a serving run
(``request_trace``).  Files are written as strict JSON (no NaN or
Infinity), which Perfetto and ``json.loads`` both read.
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


# --------------------------------------------------------------- requests
# request critical-path tracks live in their own trace process so per-rid
# tids never collide with the host/device lanes of pid 0
REQUEST_PID = 1
_EXEC_SEGMENTS = ("prefill_exec", "decode_exec", "launch_tax")


def _flow_pair_xpid(name: str, flow_id: int,
                    src_pid: int, src_tid: int, src_ts_us: float,
                    dst_pid: int, dst_tid: int, dst_ts_us: float) -> list:
    """Cross-process flow arrow (request track -> engine host lane);
    same s/f contract as ``_flow_pair`` but each end names its own pid,
    and ``cat`` namespaces the id space away from dispatch flows."""
    return [
        {"name": name, "ph": "s", "pid": src_pid, "tid": src_tid,
         "ts": src_ts_us, "id": flow_id, "cat": "request_flow"},
        {"name": name, "ph": "f", "pid": dst_pid, "tid": dst_tid,
         "ts": dst_ts_us, "id": flow_id, "cat": "request_flow",
         "bp": "e"},
    ]


def request_trace(analysis, platform: str = "",
                  host_spans=(), metadata: dict | None = None) -> dict:
    """Chrome/Perfetto trace of per-request critical paths.

    One track per request (pid ``REQUEST_PID``, tid = rid) whose slices
    are the breakdown's ordered segment pieces — the waterfall a triage
    reader scrubs.  Engine execution lanes live at pid 0, one tid per
    replica, rebuilt from the exec pieces themselves (deduped: a batched
    decode step shared by four requests is one host slice), and every
    exec piece carries a flow arrow from its request track into the host
    slice that ran it.  ``host_spans`` optionally merges a measured
    ``SpanRecorder`` dump (tids 0/1/2) into pid 0 as well, lining the
    request tracks up over the kernel lanes of ``merged_chrome_trace``.

    ``analysis`` is a ``repro_torch.telemetry.critical_path``
    ``CriticalPathAnalysis`` (duck-typed: anything with ``breakdowns``).
    """
    out = [{"name": "process_name", "ph": "M", "pid": REQUEST_PID,
            "args": {"name": "requests (critical path)"}},
           {"name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": "engine host lanes"}}]
    host_seen = set()
    flow_id = 0
    for b in analysis.breakdowns:
        host_tid = b.replica if b.replica is not None else 0
        out.append({"name": "thread_name", "ph": "M", "pid": REQUEST_PID,
                    "tid": b.rid, "args": {"name": f"request {b.rid}"}})
        for seg, t0, t1 in b.pieces:
            is_exec = seg in _EXEC_SEGMENTS
            dur = max((t1 - t0) * 1e6, 0.01)
            ev = {"name": seg, "ph": "X", "pid": REQUEST_PID,
                  "tid": b.rid, "ts": t0 * 1e6, "dur": dur,
                  "cat": "request_exec" if is_exec else "request_wait",
                  "args": {"rid": b.rid, "segment": seg}}
            if b.replica is not None:
                ev["args"]["replica"] = b.replica
            out.append(ev)
            if not is_exec or seg == "launch_tax":
                continue
            hkey = (host_tid, round(t0 * 1e6, 3), round(t1 * 1e6, 3))
            if hkey not in host_seen:
                host_seen.add(hkey)
                out.append({"name": seg, "ph": "X", "pid": 0,
                            "tid": host_tid, "ts": t0 * 1e6, "dur": dur,
                            "cat": "host_step",
                            "args": {"replica": host_tid}})
            # arrow from inside the request slice into the host slice
            out.extend(_flow_pair_xpid(
                f"{seg}[rid={b.rid}]", flow_id,
                REQUEST_PID, b.rid, t0 * 1e6 + 0.5 * dur,
                0, host_tid, t0 * 1e6 + 0.5 * dur))
            flow_id += 1
    out.extend(spans_to_chrome_events(host_spans, pid=0))
    meta = {"platform": platform} if platform else {}
    if metadata:
        meta.update(metadata)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": meta,
        "otherData": {
            "thread_names": {
                str(b.rid): f"request {b.rid}"
                for b in analysis.breakdowns},
        },
    }


def save_request_trace(analysis, path: str, *, platform: str = "",
                       host_spans=(), metadata: dict | None = None) -> str:
    """Write ``request_trace`` to ``path`` as strict JSON."""
    with open(path, "w") as f:
        json.dump(request_trace(analysis, platform,
                                host_spans=host_spans, metadata=metadata),
                  f, allow_nan=False)
    return path
