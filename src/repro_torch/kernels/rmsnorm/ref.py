"""Plain PyTorch version of the legacy two-output RMSNorm kernel
(``repro/kernels/rmsnorm/kernel.py::rmsnorm_kernel``).

It returns ``(normed, x + residual)``, or ``(normed, x)`` without a
residual.  It follows the Pallas kernel (``_rms_kernel``): the sum is taken
in f32 and the norm uses the unrounded sum, the function of
``residual_rmsnorm_ref``.  The Pallas oracle (``rmsnorm/ref.py::
rmsnorm_ref``) instead adds x + residual in x's dtype and normalises that
rounded sum; in f32 the two agree, in bf16 the normed rows differ by up to
one bf16 rounding of the sum (a relative 2^-8 per element), and the sum
output is the same rounded value in both.
"""
from __future__ import annotations

from repro_torch.kernels.fused.residual_rmsnorm.ref import residual_rmsnorm_ref

# (x (..., D), weight (D,), residual=None, eps) -> (normed, x + residual),
# both in x's dtype, the second ``x`` itself without a residual.
rmsnorm_ref = residual_rmsnorm_ref
