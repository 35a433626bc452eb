"""Backward of the fused RMSNorm + projection op (``repro_torch::
rmsnorm_matmul``), a closed-form formula in torch ops registered as its
autograd rule (``ops.py``).

The reference has no backward kernel: it differentiates its plain norm and
leaves the product to XLA.  With normed = x^ w and proj = normed W:

    dnormed = dproj W^T + d(normed output);  dW = normed^T dproj;

then the RMSNorm backward (``residual_rmsnorm/backward.py``) on dnormed.
The two products are plain ``torch.matmul`` in the operands' dtype (f32
accumulation on the card), as the forward's plain products are: 4 N D F
operations, which bound it at the training shapes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused.residual_rmsnorm.backward import rmsnorm_bwd


def rmsnorm_matmul_bwd(grad_proj, grad_normed, x, weight, w_proj, normed,
                       eps: float):
    """(dx, dweight, dw_proj) of ``rmsnorm_matmul_ref`` given its ``normed``
    output; either output gradient may be None."""
    d, f = w_proj.shape
    dnormed = None
    dw_proj = None
    if grad_proj is not None:
        gp = grad_proj.reshape(-1, f).to(w_proj.dtype)
        dnormed = torch.matmul(gp, w_proj.T).float()
        dw_proj = torch.matmul(normed.reshape(-1, d).to(w_proj.dtype).T, gp)
    if grad_normed is not None:
        gn = grad_normed.reshape(-1, d).float()
        dnormed = gn if dnormed is None else dnormed + gn
    if dnormed is None:
        return None, None, None
    ds, dw = rmsnorm_bwd(dnormed.reshape(x.shape), weight, x.float(), eps)
    return ds.to(x.dtype), dw.to(weight.dtype), \
        None if dw_proj is None else dw_proj.to(w_proj.dtype)
