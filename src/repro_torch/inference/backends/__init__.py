"""Execution backends for the serving engine: tp=1 local, tp>1 sharded
over rank processes, either optionally wrapped speculative
(``SpeculativeBackend``)."""
from repro_torch.inference.backends.base import (  # noqa: F401
    BackendInfo, CallAccount, ExecutionBackend,
)
from repro_torch.inference.backends.local import (  # noqa: F401
    PLANS, LocalBackend,
)
from repro_torch.inference.backends.speculative import (  # noqa: F401
    SpeculativeBackend,
)


def make_backend(cfg, params, *, max_batch: int, max_len: int, tp: int = 1,
                 plan: str = "jit", device="cuda",
                 platform: str = "Intel+H100"):
    """Backend for a tensor-parallel degree: tp=1 local, tp>1 sharded.

    The sharded import is deferred so single-device serving never touches
    the process-group machinery.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return LocalBackend(cfg, params, max_batch=max_batch,
                            max_len=max_len, plan=plan, device=device,
                            platform=platform)
    from repro_torch.inference.backends.sharded import ShardedBackend
    return ShardedBackend(cfg, params, max_batch=max_batch, max_len=max_len,
                          tp=tp, plan=plan, device=device, platform=platform)
