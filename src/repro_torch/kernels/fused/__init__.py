"""The fused pair: residual+RMSNorm and RMSNorm+matmul (hand CUDA kernels)."""
from repro_torch.kernels.fused.residual_rmsnorm.ops import (  # noqa: F401
    residual_rmsnorm,
)
from repro_torch.kernels.fused.rmsnorm_matmul.ops import (  # noqa: F401
    rmsnorm_matmul,
)
