"""Wrapper of the legacy two-output RMSNorm CUDA kernel
(``csrc/rmsnorm.cu``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``rmsnorm.launches`` counts kernel launches.
"""
from __future__ import annotations

from repro_torch.kernels.fused.residual_rmsnorm.ops import launch_norm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x, weight, residual=None, *, eps: float = 1e-5):
    """x: (..., D) -> (normed, x + residual), both in x's dtype.

    Without a residual the second output is ``x`` itself, and the kernel
    writes only the normed rows.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, residual, eps)
    out = launch_norm("rmsnorm_launch", "rmsnorm", x, weight, residual, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
