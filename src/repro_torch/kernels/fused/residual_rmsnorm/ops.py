"""Wrapper of the fused residual-add + RMSNorm CUDA kernel
(``csrc/residual_rmsnorm.cu``).

The wrapper calls a ``torch.library`` custom op: its CPU implementation is
the plain version (``ref.py``), its CUDA implementation launches the kernel
or raises, and its fake implementation gives a tracer the outputs' shapes.
A trace expands the op into its plain version (``core/tracing.py``).
``residual_rmsnorm.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

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
    ``entry`` (``residual_rmsnorm.cuh``); returns [normed] or, with a
    residual, [normed, sum]."""
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
    return [out] if residual is None else [out, total]


def norm_op(name: str, entry: str, wrapper):
    """The custom op ``repro_torch::<name>`` of a norm kernel: the plain
    version on the CPU, a launch of the C entry ``entry`` on the card
    (counted on ``wrapper``).  It returns [normed] without a residual and
    [normed, sum] with one: an op's output may not be its input, so the
    wrapper hands back ``x`` itself as the sum."""

    @torch.library.custom_op(f"repro_torch::{name}", mutates_args=(),
                             device_types="cpu")
    def op(x: torch.Tensor, weight: torch.Tensor,
           residual: Optional[torch.Tensor], eps: float) -> list[torch.Tensor]:
        out, total = residual_rmsnorm_ref(x, weight, residual, eps)
        return [out] if residual is None else [out, total]

    @op.register_kernel("cuda")
    def launch(x, weight, residual, eps):
        out = launch_norm(entry, name, x, weight, residual, eps)
        wrapper.launches += 1
        return out

    @op.register_fake
    def fake(x, weight, residual, eps):
        return [torch.empty_like(x) for _ in range(1 + (residual is not None))]

    return op


def norm_costs(x, weight, residual, eps) -> tuple:
    """(flops, bytes) of a norm launch: a few operations an element; x,
    the scale, the residual and the outputs moved once."""
    return (4.0 * x.numel(), float(build.nbytes(x, weight, residual, x)
                                   + (0 if residual is None
                                      else build.nbytes(x))))


def call_norm(op, x, weight, residual, eps):
    build.require_placed(op._qualname, x)
    outs = op._opoverload(x, weight, residual, float(eps))
    return outs[0], (x if residual is None else outs[1])


def residual_rmsnorm(x, weight, residual=None, *, eps: float = 1e-5):
    """x: (..., D) -> (normed, pre-norm sum), both in x's dtype.

    Without a residual the pre-norm sum is the input itself: ``x`` is
    returned and the kernel writes only the normed rows.
    """
    return call_norm(_op, x, weight, residual, eps)


_op = norm_op("residual_rmsnorm", "residual_rmsnorm_launch",
              residual_rmsnorm)
residual_rmsnorm.launches = 0
residual_rmsnorm.op = _op._opoverload
residual_rmsnorm.costs = norm_costs
