"""Wrapper of the fused RMSNorm + projection CUDA kernel
(``csrc/rmsnorm_matmul.cu``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``rmsnorm_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref

_ARGS = [build.P, build.P, build.P, build.P, build.P, build.I, build.I,
         build.I, build.I, build.F, build.I, build.P]
_SMEM = 48 * 1024            # static shared budget of one CTA
_PART_BYTES = 8 * 8 * 32 * 4  # the kernel's K-slice partial sums
MAX_ROWS_PER_CTA = 8


def rows_per_cta(d: int) -> int:
    """Rows one CTA normalises and holds in shared memory at width d."""
    return min(MAX_ROWS_PER_CTA, (_SMEM - _PART_BYTES) // (4 * d))


def rmsnorm_matmul(x, weight, w_proj, *, eps: float = 1e-5):
    """x: (..., D), weight: (D,), w_proj: (D, F) ->
    (proj (..., F) in w_proj's dtype, normed (..., D) in x's dtype)."""
    if x.device.type == "cpu":
        return rmsnorm_matmul_ref(x, weight, w_proj, eps)
    build.require_cuda("rmsnorm_matmul", x, weight, w_proj)
    d = x.shape[-1]
    if weight.shape != (d,) or w_proj.dim() != 2 or w_proj.shape[0] != d:
        raise ValueError(f"rmsnorm_matmul: x (..., {d}) needs weight ({d},) "
                         f"and w_proj ({d}, F), got {tuple(weight.shape)} "
                         f"and {tuple(w_proj.shape)}")
    if weight.dtype != x.dtype or w_proj.dtype != x.dtype:
        raise ValueError("rmsnorm_matmul: all tensors must share one dtype")
    if not (x.is_contiguous() and weight.is_contiguous()
            and w_proj.is_contiguous()):
        raise ValueError("rmsnorm_matmul: tensors must be contiguous")
    rows = rows_per_cta(d)
    if rows < 1:
        raise ValueError(f"rmsnorm_matmul: D={d} too wide for one CTA")
    f = w_proj.shape[1]
    n = x.numel() // d
    proj = torch.empty(x.shape[:-1] + (f,), dtype=w_proj.dtype,
                       device=x.device)
    normed = torch.empty_like(x)
    fn = build.function("rmsnorm_matmul_launch", _ARGS)
    code = fn(x.data_ptr(), weight.data_ptr(), w_proj.data_ptr(),
              proj.data_ptr(), normed.data_ptr(), n, d, f, rows, eps,
              build.dtype_code(x), build.stream_ptr(x))
    build.check(code, "rmsnorm_matmul")
    rmsnorm_matmul.launches += 1
    return proj, normed


rmsnorm_matmul.launches = 0
