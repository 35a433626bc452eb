"""Platform models and the in-order offload/queue simulator (paper Fig. 4).

Copy of ``repro/core/device_model.py``.  Device-side kernel durations are
MODELED per kernel as ``max(flops/peak, bytes/bw) + fixed_overhead`` with
the paper's Table V launch overheads and nullKernel durations and public
accelerator data sheets: modeled numbers, never this machine's.  On the
card the port also MEASURES the same timeline: ``KernelEvent``s built
from ``torch.profiler`` (a kernel joined to the runtime call that launched
it) feed the same ``core.metrics.report``.

Simulator semantics (Eq. 1): a kernel's launch call begins on the host at
``ts_b(l)``; the kernel starts executing at
``max(host launch done, device free)``; ``t_l = kernel_start - ts_b(l)``;
TKLQT = sum of t_l (Eq. 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class PlatformSpec:
    name: str
    coupling: str                  # LC | CC | TC | host
    launch_overhead_ns: float      # nullKernel launch overhead (Table V)
    null_duration_ns: float        # nullKernel execution time (Table V)
    peak_flops: float              # fp16/bf16 dense
    hbm_bw: float                  # bytes/s
    # per-op CPU framework tax beyond the null launch (python/op-prep work)
    op_tax_ns: float = 6000.0
    mxu_efficiency: float = 0.4    # attainable fraction of peak for GEMMs
    bw_efficiency: float = 0.7
    # host<->device coupling fabric (the LC-vs-CC axis): sustained one-way
    # bandwidth of the link KV blocks cross when offloaded to host memory
    # (PCIe for LC parts, NVLink-C2C for CC parts) plus a per-transfer
    # latency floor.  This prices the paged-KV offload tier.
    link_bw: float = 32e9          # bytes/s, one direction
    link_lat_s: float = 10e-6      # per-transfer setup latency
    link_efficiency: float = 0.8   # attainable fraction of peak link bw

    @property
    def host_cost_ns(self) -> float:
        return self.launch_overhead_ns + self.op_tax_ns


# Table V launch/duration numbers; public specs for compute/bandwidth;
# op_tax = 6 us reference (Xeon 8468V) / relative single-thread perf.
PLATFORMS = {
    # LC: AMD EPYC 7313 + A100-SXM4-80GB (312 TF fp16 dense, 2.04 TB/s);
    # host link PCIe Gen4 x16 (~32 GB/s/dir)
    "AMD+A100": PlatformSpec("AMD+A100", "LC", 2260.5, 1440.0,
                             312e12, 2.039e12, op_tax_ns=6650.0,
                             link_bw=32e9),
    # LC: 2P Xeon 8468V + H100 PCIe (756 TF fp16 dense, 2.0 TB/s);
    # host link PCIe Gen5 x16 (~64 GB/s/dir)
    "Intel+H100": PlatformSpec("Intel+H100", "LC", 2374.6, 1235.2,
                               756e12, 2.0e12, op_tax_ns=6000.0,
                               link_bw=64e9),
    # CC: GH200 (Grace + H100-SXM-class 96GB HBM3, ~990 TF fp16, 3.35 TB/s);
    # host link NVLink-C2C (~450 GB/s/dir) with a much lower setup latency
    "GH200": PlatformSpec("GH200", "CC", 2771.6, 1171.2,
                          989e12, 3.35e12, op_tax_ns=15000.0,
                          link_bw=450e9, link_lat_s=2e-6),
    # the reference's TPU target (per chip); the planner's default row
    "TPU-v5e": PlatformSpec("TPU-v5e", "CC", 2500.0, 1200.0,
                            197e12, 819e9, op_tax_ns=6000.0,
                            link_bw=32e9),
}


@dataclass
class KernelEvent:
    """One simulated kernel launch+execution (timeline entry)."""
    name: str
    launch_begin: float            # ts_b(l)
    launch_end: float              # host done issuing the call
    kernel_start: float            # ts_b(k)
    kernel_end: float              # ts_e(k)
    operator: str = ""             # issuing model operator (provenance tag)

    @property
    def t_l(self) -> float:        # Eq. 1
        return self.kernel_start - self.launch_begin

    @property
    def t_launch(self) -> float:   # pure host launch component
        return self.launch_end - self.launch_begin

    @property
    def t_queue(self) -> float:    # queuing component of t_l
        return self.kernel_start - self.launch_end

    @property
    def duration(self) -> float:
        return self.kernel_end - self.kernel_start


@dataclass
class DispatchDecomposition:
    """Per-kernel launch/queue/exec breakdown of one simulated timeline.

    TKLQT (Eq. 2) stops being one opaque scalar: for every kernel,
    ``t_l = t_launch + t_queue`` with queue time = max(0, host-issue done
    − device free), so ``tklqt_s`` below is a *real sum over kernels*
    that per-operator attribution can slice."""
    rows: list                     # [(name, operator, launch_s, queue_s, exec_s)]
    launch_s: float
    queue_s: float
    exec_s: float

    @property
    def tklqt_s(self) -> float:
        return self.launch_s + self.queue_s


def decompose_events(events: Sequence) -> DispatchDecomposition:
    """Break a KernelEvent timeline into launch/queue/exec components."""
    rows = []
    launch = queue = exec_ = 0.0
    for e in events:
        rows.append((e.name, getattr(e, "operator", ""),
                     e.t_launch, e.t_queue, e.duration))
        launch += e.t_launch
        queue += e.t_queue
        exec_ += e.duration
    return DispatchDecomposition(rows, launch, queue, exec_)


def offload_cost_s(platform: PlatformSpec, nbytes: float,
                   transfers: int = 1) -> float:
    """Modeled host<->device transfer time for ``nbytes`` of KV blocks
    crossing the coupling fabric in ``transfers`` separate copies: a
    per-transfer latency floor plus the bytes over the sustained link
    bandwidth."""
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    return (transfers * platform.link_lat_s
            + nbytes / (platform.link_bw * platform.link_efficiency))


def allreduce_cost_s(platform: PlatformSpec, nbytes: float,
                     tp: int = 1) -> float:
    """Modeled time for one all-reduce of ``nbytes`` payload across a
    ``tp``-way tensor-parallel group.

    Ring all-reduce wire model: each device sends/receives
    ``2*(tp-1)/tp * nbytes`` over the inter-device fabric, paid at the
    platform's sustained link bandwidth, plus a per-hop latency floor —
    ``2*(tp-1)`` ring steps.  On LC parts the TP fabric is the same
    PCIe complex the KV offload crosses; on CC parts it is NVLink-class,
    so the same ``link_bw`` axis that separates LC/CC offload tax also
    separates their collective tax (Kundu et al.'s distributed-inference
    model collapses to this term for decode-size payloads, where latency
    floors dominate bandwidth).
    """
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return 0.0
    steps = 2 * (tp - 1)
    wire = 2.0 * (tp - 1) / tp * nbytes
    return (steps * platform.link_lat_s
            + wire / (platform.link_bw * platform.link_efficiency))


def dispatch_fanout_s(platform: PlatformSpec, tp: int = 1) -> float:
    """Modeled host cost of issuing ONE logical launch to ``tp`` device
    streams: the CPU pays the per-launch overhead once per device (the
    driver enqueues per-stream), which is exactly how kernel-launch
    overheads multiply with device count in multi-GPU serving (Chung et
    al.) — the CPU-bound region widens with tp."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return platform.host_cost_ns * 1e-9 * tp


def kernel_duration(platform: PlatformSpec, flops: float, bts: float) -> float:
    """Modeled device time (seconds) for one kernel."""
    t_c = flops / (platform.peak_flops * platform.mxu_efficiency)
    t_m = bts / (platform.hbm_bw * platform.bw_efficiency)
    return max(t_c, t_m) + platform.null_duration_ns * 1e-9


def simulate(kernels: Sequence, platform: PlatformSpec, *,
             batch_scale: float = 1.0,
             host_scale: Optional[Sequence[float]] = None) -> list[KernelEvent]:
    """Run the in-order queue model over a kernel list.

    kernels: objects with .name, .flops, .bytes and optional
             .host_dispatch_s (measured host time for this op).
    batch_scale: multiply flops/bytes (trace-once, sweep-batch analytically —
                 every kernel in these workloads is linear in batch).
    host_scale: optional per-kernel relative host cost (measured host time /
                measured null time); launch_i = platform_launch * rel_i.
    """
    t_host = 0.0
    device_free = 0.0
    events = []
    base_launch = platform.host_cost_ns * 1e-9
    for i, k in enumerate(kernels):
        rel = 1.0
        if host_scale is not None:
            rel = max(host_scale[i], 1.0)
        launch = base_launch * rel
        launch_begin = t_host
        t_host = t_host + launch                 # host issues the call, moves on
        dur = kernel_duration(platform, k.flops * batch_scale,
                              k.bytes * batch_scale)
        start = max(t_host, device_free)         # queue behind running kernels
        end = start + dur
        device_free = end
        events.append(KernelEvent(k.name, launch_begin, t_host, start, end,
                                  operator=getattr(k, "operator", "")))
    return events
