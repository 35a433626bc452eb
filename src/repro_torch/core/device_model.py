"""Platform rows of the paper and the modeled host-link transfer cost.

Minimal copy of ``repro/core/device_model.py``: ``PlatformSpec``, the
paper's three GPU platforms of ``PLATFORMS`` and ``offload_cost_s``, which
prices the paged cache's host offload.  The launch and duration constants
are the paper's Table V measurements, the compute and bandwidth figures
public data sheets: modeled numbers, never this machine's.
"""
from __future__ import annotations

from dataclasses import dataclass


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
}


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
