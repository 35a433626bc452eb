"""Wrapper of the legacy two-output RMSNorm CUDA kernel
(``csrc/rmsnorm.cu``).

The wrapper calls the custom op ``repro_torch::rmsnorm`` (built as the
fused norm's is, ``residual_rmsnorm/ops.py``): the plain version on the
CPU, the kernel's launch on the card.  ``rmsnorm.launches`` counts kernel
launches.
"""
from __future__ import annotations

from repro_torch.kernels.fused.residual_rmsnorm.ops import (call_norm,
                                                            norm_costs,
                                                            norm_op)


def rmsnorm(x, weight, residual=None, *, eps: float = 1e-5):
    """x: (..., D) -> (normed, x + residual), both in x's dtype.

    Without a residual the second output is ``x`` itself, and the kernel
    writes only the normed rows.
    """
    return call_norm(_op, x, weight, residual, eps)


_op = norm_op("rmsnorm", "rmsnorm_launch", rmsnorm)
rmsnorm.launches = 0
rmsnorm.op = _op._opoverload
rmsnorm.costs = norm_costs
