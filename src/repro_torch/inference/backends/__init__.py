"""Execution backends for the serving engine: tp=1 local, optionally
wrapped speculative (``SpeculativeBackend``)."""
from repro_torch.inference.backends.base import (  # noqa: F401
    BackendInfo, CallAccount, ExecutionBackend,
)
from repro_torch.inference.backends.local import (  # noqa: F401
    NOT_PORTED, PLANS, LocalBackend,
)
from repro_torch.inference.backends.speculative import (  # noqa: F401
    SpeculativeBackend,
)


def make_backend(cfg, params, *, max_batch: int, max_len: int, tp: int = 1,
                 plan: str = "jit", device="cuda",
                 platform: str = "Intel+H100"):
    """Backend for a tensor-parallel degree; only tp=1 is ported."""
    if tp != 1:
        raise ValueError(f"tp={tp}: tensor-parallel serving {NOT_PORTED}, "
                         "\"tensor parallel\"")
    return LocalBackend(cfg, params, max_batch=max_batch, max_len=max_len,
                        plan=plan, device=device, platform=platform)
