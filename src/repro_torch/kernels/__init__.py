"""Hand-written Hopper kernels of the port, one wrapper each.

Each wrapper calls a ``torch.library`` custom op (``wrapper.op``) whose CPU
implementation is the plain PyTorch version beside it (``ref.py``), whose
CUDA implementation launches the kernel, and whose fake implementation
gives a tracer its outputs, so a traced step holds each launch as one
node; ``wrapper.costs`` gives a launch's FLOPs and bytes.  A launch count
(``wrapper.launches``) grows by one per kernel launch and nowhere else; a
CUDA graph replay, which launches the kernels it captured without calling
the wrappers, credits them (``credit_launches``).  The model calls the
wrappers through this module, so a test can substitute a spy for any of
them.
"""
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_mq, paged_decode_attention,
    paged_decode_attention_mq, paged_decode_attention_quant,
    paged_decode_attention_quant_mq)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.fused import residual_rmsnorm, rmsnorm_matmul
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rwkv6.ops import wkv6

WRAPPERS = {
    "decode_attention": decode_attention,
    "decode_attention_mq": decode_attention_mq,
    "flash_attention": flash_attention,
    "paged_decode_attention": paged_decode_attention,
    "paged_decode_attention_quant": paged_decode_attention_quant,
    "paged_decode_attention_mq": paged_decode_attention_mq,
    "paged_decode_attention_quant_mq": paged_decode_attention_quant_mq,
    "residual_rmsnorm": residual_rmsnorm,
    "rmsnorm_matmul": rmsnorm_matmul,
    "rmsnorm": rmsnorm,
    "wkv6": wkv6,
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def credit_launches(counts: dict) -> None:
    """Add ``counts`` (wrapper name -> launches) to the wrappers' counts."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n
