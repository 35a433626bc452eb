"""Plain PyTorch version of the fused residual-add + RMSNorm kernel."""
from __future__ import annotations

import torch


def residual_rmsnorm_ref(x, weight, residual=None, eps: float = 1e-5):
    """x: (..., D); weight: (D,); optional residual added before the norm.

    Follows the Pallas kernel (``_res_rms_kernel``): the sum is taken in
    f32 and the norm uses the unrounded sum; both outputs are cast to x's
    dtype.  Returns ``(normed, pre_norm_sum)``, the sum being ``x`` itself
    when no residual is given.
    """
    s = x.float()
    if residual is not None:
        s = s + residual.float()
    var = s.square().mean(dim=-1, keepdim=True)
    out = s * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype), (x if residual is None else s.to(x.dtype))
