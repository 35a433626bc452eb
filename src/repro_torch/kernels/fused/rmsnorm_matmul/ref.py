"""Plain PyTorch version of the fused RMSNorm + projection kernel."""
from __future__ import annotations

import torch


def rmsnorm_matmul_ref(x, weight, w_proj, eps: float = 1e-5):
    """x: (..., D); weight: (D,); w_proj: (D, F).

    Follows the Pallas kernel (``_rms_mm_kernel``): f32 statistics, the
    normed rows rounded to x's dtype before the product, the product
    accumulated in f32 and stored in ``w_proj``'s dtype.  Returns
    ``(proj, normed)``.
    """
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
    proj = torch.matmul(normed.float(), w_proj.float()).to(w_proj.dtype)
    return proj, normed
