"""Backward of the residual-add + RMSNorm ops (``repro_torch::
residual_rmsnorm`` and the legacy ``repro_torch::rmsnorm``), a closed-form
formula in torch ops registered as their autograd rule (``ops.norm_op``).

The reference has no backward kernel: it differentiates its plain norm.
With s = x (+ r) and x^ = s rstd, rstd = rsqrt(mean(s^2) + eps), in f32
as the forward's statistics:

    dx^ = w dy;  ds = rstd (dx^ - x^ mean(dx^ x^)) + d(sum);  dw = sum dy x^,

and dr = dx = ds.  It reads x (and r), w and the output gradients once and
writes dx (and dr) and dw: bound by those bytes.
"""
from __future__ import annotations

import torch


def norm_stats(s: torch.Tensor, eps: float):
    """(x^, rstd) of the f32 pre-norm rows ``s``."""
    rstd = torch.rsqrt(s.square().mean(dim=-1, keepdim=True) + eps)
    return s * rstd, rstd


def rmsnorm_bwd(grad_normed, weight, s, eps: float):
    """(ds f32, dw f32) of ``s -> s rstd w`` at the f32 rows ``s``;
    ``grad_normed`` in any dtype."""
    xhat, rstd = norm_stats(s, eps)
    g = grad_normed.float()
    dxhat = g * weight.float()
    ds = rstd * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dw = (g * xhat).reshape(-1, s.shape[-1]).sum(dim=0)
    return ds, dw


def residual_rmsnorm_bwd(grad_normed, grad_sum, x, weight, residual,
                         eps: float):
    """(dx, dweight, dresidual) of ``residual_rmsnorm_ref`` (dresidual None
    without a residual), each in its input's dtype.  ``grad_sum`` is the
    gradient of the pre-norm sum output, or None."""
    s = x.float()
    if residual is not None:
        s = s + residual.float()
    ds, dw = rmsnorm_bwd(grad_normed, weight, s, eps)
    if grad_sum is not None:
        ds = ds + grad_sum.float()
    return (ds.to(x.dtype), dw.to(weight.dtype),
            None if residual is None else ds.to(residual.dtype))
