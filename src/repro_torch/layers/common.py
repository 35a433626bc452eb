"""Shared layer primitives: norms, rotary embeddings, MLP, embed/unembed.

Counterpart of ``repro/layers/common.py``.  Weights keep the reference
layout: (D, F) matrices applied as ``x @ W``, the tied unembed as
``x @ embed.T``.  Random init draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float = 0.02) -> torch.Tensor:
    """``scale`` * standard normal drawn in f32 from ``gen`` on the
    generator's own device, then cast and placed on ``device``.  On the
    meta device nothing is drawn: the tensor has the shape and dtype
    only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(device=device, dtype=dtype)


def rmsnorm(x, weight, eps: float = 1e-5, plus_one: bool = False):
    """RMSNorm in fp32 with cast-back (gemma uses the (1+w) form)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (xf * w).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of shape (..., S, 1, hd/2) in f32 for ``apply_rope``;
    computed once per forward and shared by every layer."""
    angles = positions[..., None].float() * rope_freqs(head_dim, theta,
                                                       positions.device)
    angles = angles[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, tables):
    """Half-split RoPE in f32.  x: (..., S, H, hd); tables from
    ``rope_tables`` over the same positions."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(x, act: str):
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


def mlp_init(gen, cfg: ModelConfig, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_in": dense_init(gen, (d, f), cfg.pdtype, device),
         "w_out": dense_init(gen, (f, d), cfg.pdtype, device)}
    if cfg.glu:
        p["w_gate"] = dense_init(gen, (d, f), cfg.pdtype, device)
    return p


def mlp_fwd(params, x, cfg: ModelConfig, reduce=None):
    """Gated (SwiGLU) or plain MLP.  ``reduce`` is the tensor-parallel
    output hook: with ``w_in``/``w_gate`` column-sharded and ``w_out``
    row-sharded (Megatron layout), ``h @ w_out`` is one rank's partial sum
    and ``reduce("mlp_out", y)`` all-reduces it; None is identity."""
    h = x @ params["w_in"]
    if cfg.glu:
        h = activation(x @ params["w_gate"], cfg.act) * h
    else:
        h = activation(h, cfg.act)
    y = h @ params["w_out"]
    return reduce("mlp_out", y) if reduce is not None else y


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


def embed_tokens(embedding, tokens, cfg: ModelConfig):
    x = embedding[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(x, embedding, head, cfg: ModelConfig):
    """Logits in f32: ``x @ embed.T`` (tied) or ``x @ head``, computed in
    x's dtype and then widened, as the reference does."""
    w = embedding.T if cfg.tie_embeddings else head
    logits = x @ w.to(x.dtype)
    return softcap(logits.float(), cfg.final_softcap)
