"""Wrapper of the fused residual-add + RMSNorm CUDA kernel
(``csrc/residual_rmsnorm.cu``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``residual_rmsnorm.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused.residual_rmsnorm.ref import residual_rmsnorm_ref

_ARGS = [build.P, build.P, build.P, build.P, build.P, build.I, build.I,
         build.F, build.I, build.P]
# The kernel keeps a row in registers: at most 256 threads of 10 16-byte
# vectors each (NORM_MAX_THREADS x NORM_MAX_NV in csrc/residual_rmsnorm.cuh).
MAX_ROW_BYTES = 256 * 10 * 16


def launch_norm(entry: str, name: str, x, weight, residual, eps: float):
    """Check the tensors and launch the norm kernel through the C entry
    ``entry`` (``residual_rmsnorm.cuh``); returns (normed, sum or x)."""
    tensors = (x, weight) if residual is None else (x, weight, residual)
    build.require_cuda(name, *tensors)
    d = x.shape[-1]
    if weight.shape != (d,) or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"{name}: weight must be (D,) and all tensors of "
                         "one dtype")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"{name}: residual {tuple(residual.shape)} != x "
                         f"{tuple(x.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if d * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"{name}: rows of {d} x {x.dtype} exceed the "
                         f"{MAX_ROW_BYTES} bytes the kernel holds")
    out = torch.empty_like(x)
    total = None if residual is None else torch.empty_like(x)
    fn = build.function(entry, _ARGS)
    code = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
              weight.data_ptr(), out.data_ptr(),
              None if total is None else total.data_ptr(),
              x.numel() // d, d, eps, build.dtype_code(x), build.stream_ptr(x))
    build.check(code, name)
    return out, (x if residual is None else total)


def residual_rmsnorm(x, weight, residual=None, *, eps: float = 1e-5):
    """x: (..., D) -> (normed, pre-norm sum), both in x's dtype.

    Without a residual the pre-norm sum is the input itself: ``x`` is
    returned and the kernel writes only the normed rows.
    """
    if x.device.type == "cpu":
        return residual_rmsnorm_ref(x, weight, residual, eps)
    out = launch_norm("residual_rmsnorm_launch", "residual_rmsnorm", x,
                      weight, residual, eps)
    residual_rmsnorm.launches += 1
    return out


residual_rmsnorm.launches = 0
