"""Model configuration dataclasses and the architecture registry.

A copy of ``repro/configs/base.py`` with torch dtypes: the port keeps its
own copy so that it never imports the JAX package.  Field names, defaults
and ``reduced()`` match the reference exactly, so a config built here and
one built there describe the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named by a config dtype string."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; have "
                         f"{sorted(_TORCH_DTYPES)}") from None


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch_chunks: int = 1


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # layer stack = superblocks, each applying block_pattern in order
    block_pattern: Tuple[str, ...] = ("attn",)
    moe_slots: Tuple[int, ...] = ()
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rope_theta: float = 10000.0
    sliding_window: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False
    attn_scale: float = 0.0       # 0 -> 1/sqrt(head_dim)
    tie_embeddings: bool = False
    embed_scale: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"
    glu: bool = True
    n_encoder_layers: int = 0
    frontend: str = "none"
    n_frontend_tokens: int = 0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern len {len(self.block_pattern)}")
        return self.n_layers // len(self.block_pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell: an input-shape configuration."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the configs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Which benchmark shapes apply to an arch (long_500k only if
    sub-quadratic)."""
    return [s.name for s in SHAPES.values()
            if s.name != "long_500k" or cfg.subquadratic]


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (same rule as the reference)."""
    pat = cfg.block_pattern
    kw = dict(
        n_layers=len(pat) * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=503,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=64,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            capacity_factor=4.0)
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, d_conv=4)
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
    if cfg.n_frontend_tokens:
        kw["n_frontend_tokens"] = 8
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    kw.update(overrides)
    return cfg.replace(**kw)
