"""Device resolution for every entry point of the port.

Entry points take ``device="cuda"`` by default.  Asking for the GPU on a
machine without one raises: the port never falls back to the CPU behind
the caller's back.  The CPU runs only when the caller passes ``"cpu"``
(the tests do), and then every kernel wrapper runs its plain version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev
