"""Optimizers: AdamW and Adafactor (factored second moment), global-norm
clipping and the warmup-cosine schedule, over the port's parameter trees.

Counterpart of ``repro/training/optim.py``, with the reference's arithmetic
and casts: the state is f32; a bf16 gradient is clipped in bf16 and its
``(1 - b1) g`` and ``(1 - b2) g g`` terms are taken in bf16, with the
scalars rounded to bf16 first, before they meet the f32 state, as JAX's
weakly typed scalars do; the update is
computed in f32 from the parameter widened to f32 and cast back to the
parameter's dtype.  Weight decay applies to every leaf.

Unlike the reference's pure functions, the updates write the parameters
and the state in place under ``torch.no_grad()`` (and return them), so a
step allocates no second copy of the model.  AdamW runs as ``torch.
_foreach_*`` ops over all leaves together (those that mix a bf16 and an
f32 list loop over the leaves inside one call).  The step count is a 0-d int32 CPU tensor, so reading it
needs no device sync.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tree import leaves, map_tree, named_leaves


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"           # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step) -> float:
    """The learning rate at ``step`` (linear warmup, then cosine down to
    ``min_lr_frac``), in f32 as the reference computes it."""
    f32 = np.float32
    step = f32(int(step))
    warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * f32(0.5) * (
        f32(1.0) + np.cos(f32(np.pi) * prog))
    return float(f32(cfg.lr) * warm * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    norms = torch._foreach_norm(leaves(tree), 2, dtype=torch.float32)
    return torch.stack(norms).square().sum().sqrt()


def _clip_scale(grads, max_norm: float):
    g = global_norm(grads)
    return torch.clamp(max_norm / (g + 1e-9), max=1.0), g


def _scaled(xs: list, scale: torch.Tensor) -> list:
    """Each tensor times ``scale`` cast to its dtype (one foreach launch a
    dtype), in its dtype."""
    out = [None] * len(xs)
    for dtype in {x.dtype for x in xs}:
        idx = [i for i, x in enumerate(xs) if x.dtype == dtype]
        for i, y in zip(idx, torch._foreach_mul(
                [xs[i] for i in idx], scale.to(xs[idx[0]].device, dtype))):
            out[i] = y
    return out


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm): each gradient keeps
    its dtype (an f32 copy of bf16 gradients would double them)."""
    scale, g = _clip_scale(grads, max_norm)
    values = iter(_scaled(leaves(grads), scale))
    return map_tree(lambda _: next(values), grads), g


def _weak(c: float, xs: list) -> list:
    """``c`` rounded to each tensor's dtype: a Python scalar times a bf16
    array is a bf16 product of bf16(c) in JAX (a weakly typed scalar takes
    the array's dtype first), where torch would multiply by c in f32."""
    rounded = {d: float(torch.tensor(c, dtype=d)) for d in {x.dtype
                                                           for x in xs}}
    return [rounded[x.dtype] for x in xs]


def _step(state) -> int:
    return int(state["step"]) + 1


# ------------------------------------------------------------------ adamw
def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32),
            "m": map_tree(zeros, params), "v": map_tree(zeros, params)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    """One AdamW step, in place; returns (params, state, {"lr",
    "grad_norm"})."""
    step = _step(state)
    lr = schedule(cfg, step)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    gs, ps = _scaled(leaves(grads), scale), leaves(params)
    ms, vs = leaves(state["m"]), leaves(state["v"])
    b1, b2 = cfg.b1, cfg.b2
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, _weak(1 - b1, gs)))
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, torch._foreach_mul(
        torch._foreach_mul(gs, _weak(1 - b2, gs)), gs))
    bc1 = float(1 - np.float32(b1) ** np.float32(step))
    bc2 = float(1 - np.float32(b2) ** np.float32(step))
    den = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    u = torch._foreach_div(ms, bc1)
    torch._foreach_div_(u, den)
    del den
    # u + wd p and p - lr u, each taken in f32 from the parameter widened
    # to f32 and rounded once to its dtype
    torch._foreach_add_(u, ps, alpha=cfg.weight_decay)
    torch._foreach_add_(ps, u, alpha=-lr)
    state["step"].fill_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ------------------------------------------------------------------ adafactor
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params) -> dict:
    def per_leaf(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    return {"step": torch.zeros((), dtype=torch.int32),
            "v": map_tree(per_leaf, params)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    """One Adafactor step (factored second moment, update clipping to RMS
    1), in place; returns (params, state, {"lr", "grad_norm"})."""
    step = _step(state)
    lr = schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    decay = float(1.0 - np.float32(step) ** np.float32(-0.8))
    slots = dict(named_leaves(state["v"]))
    for (key, p), g in zip(named_leaves(params), leaves(grads)):
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr, vc = slots[f"{key}/vr"], slots[f"{key}/vc"]
            # the reference's decay is an f32 array: its products with the
            # bf16 means are taken in f32
            vr.copy_(decay * vr + (1 - decay) * g2.mean(dim=-1).float())
            vc.copy_(decay * vc + (1 - decay) * g2.mean(dim=-2).float())
            rfac = (vr / vr.mean(dim=-1, keepdim=True))[..., None]
            u = g * torch.rsqrt(rfac * vc[..., None, :] + 1e-30)
        else:
            v = slots[f"{key}/v"]
            v.copy_(decay * v + (1 - decay) * g2.float())
            u = g * torch.rsqrt(v + 1e-30)
        # update clipping (RMS <= 1)
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        p32 = p.float()
        u = u + cfg.weight_decay * p32
        p.copy_(p32 - lr * u)
    state["step"].fill_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ------------------------------------------------------------------ facade
def opt_init(cfg: OptConfig, params) -> dict:
    return adafactor_init(params) if cfg.kind == "adafactor" \
        else adamw_init(params)


def opt_update(cfg: OptConfig, grads, state, params):
    if cfg.kind == "adafactor":
        return adafactor_update(cfg, grads, state, params)
    return adamw_update(cfg, grads, state, params)
