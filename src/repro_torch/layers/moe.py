"""Mixture-of-Experts: router, capacity dispatch, all experts on one device.

Counterpart of ``repro/layers/moe.py``'s single-device path, which serving
runs (``moe_fwd`` with ``dist=None``, i.e. ``moe_local_fwd``):

* ``moe_dense_fwd`` — every expert on every token (the tests' oracle);
* ``moe_local_fwd`` — sort-based capacity dispatch, every expert local.

Capacity dropping: C = ceil(T*k/E * capacity_factor) rounded up to a
multiple of 8 (at least 8), from the T tokens of the call; an expert's
assignments past C are dropped (Switch semantics).  So one token's output
depends on every token of the call: the same rows must be routed together
as in the reference.

The dispatch picks nothing by value on the host: a stable sort, a
``searchsorted`` and a scatter into an ``E*C + 1``-row buffer whose last
row takes the drops, with C host arithmetic on the static token count.
A step body that calls it is captured once per signature as a CUDA graph.
Ties resolve as JAX's do, lower index first: top-k is a stable descending
sort, the dispatch order a stable ascending one.

Expert parallelism (``moe_ep_fwd`` over a mesh) is not ported:
``moe_fwd(dist=...)`` raises, naming ROADMAP Queue A "training and launch
tooling" (the reference reaches it only from its train and dry-run step
builders; its sharded serving backend refuses MoE stacks).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import activation, dense_init

# f32 bytes one draw of an expert tensor may take on the generator's device
# (Kimi K2's w_in whole would take 22.5 GB)
INIT_CHUNK_BYTES = 1 << 30


def _expert_init(gen, shape, dtype, device, scale: float = 0.02):
    """``dense_init`` of an (E, ...) expert tensor, drawn a few experts at
    a time so that the f32 draw never holds more than INIT_CHUNK_BYTES."""
    out = torch.empty(shape, dtype=dtype, device=device)
    per = max(1, INIT_CHUNK_BYTES // (4 * math.prod(shape[1:])))
    for lo in range(0, shape[0], per):
        n = min(per, shape[0] - lo)
        out[lo:lo + n] = dense_init(gen, (n,) + tuple(shape[1:]), dtype,
                                    device, scale)
    return out


def moe_init(gen, cfg: ModelConfig, device) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, device, scale=0.006),
        "w_in": _expert_init(gen, (e, d, f), cfg.pdtype, device),
        "w_gate": _expert_init(gen, (e, d, f), cfg.pdtype, device),
        "w_out": _expert_init(gen, (e, f, d), cfg.pdtype, device),
    }
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        p["shared_in"] = dense_init(gen, (d, fs), cfg.pdtype, device)
        p["shared_gate"] = dense_init(gen, (d, fs), cfg.pdtype, device)
        p["shared_out"] = dense_init(gen, (fs, d), cfg.pdtype, device)
    return p


# ------------------------------------------------------------------ router
def route(x2d, router_w, cfg: ModelConfig, with_aux: bool = True):
    """x2d: (T, D) -> gates (T,k) f32, eids (T,k) int64, the Switch
    load-balancing aux scalar (None without ``with_aux``)."""
    m = cfg.moe
    logits = x2d.float() @ router_w.float()                        # (T,E)
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = srt[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True)                 # renorm
    if not with_aux:
        return gates, eids, None
    onehot = F.one_hot(eids, m.n_experts).float()                  # (T,k,E)
    f_e = onehot.sum(dim=1).mean(dim=0)                             # (E,)
    p_e = probs.mean(dim=0)                                         # (E,)
    aux = m.n_experts * (f_e * p_e).sum() / m.top_k
    return gates, eids, aux


def capacity(t_local: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(-(-t_local * m.top_k * m.capacity_factor // m.n_experts))
    return max(8, -(-c // 8) * 8)


def dispatch_slots(eids, n_experts: int, cap: int):
    """Sort-based position-in-expert.  eids: (T,k) -> slots (T*k,), keep
    (T*k,).  slot = expert_id * cap + position within the expert for kept
    assignments; dropped ones get slot = n_experts*cap (a dump row)."""
    flat_e = eids.reshape(-1)
    tk = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat_e.device,
                               dtype=sorted_e.dtype), side="left")
    pos_sorted = (torch.arange(tk, device=flat_e.device)
                  - seg_start[sorted_e])
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return slot, keep


def expert_ffn(w_in, w_gate, w_out, xb, act: str):
    """xb: (E, N, D) batched per-expert FFN."""
    h = torch.bmm(xb, w_in)
    g = torch.bmm(xb, w_gate)
    return torch.bmm(activation(g, act) * h, w_out)


def _shared(params, x2d, cfg: ModelConfig):
    if "shared_in" not in params:
        return 0.0
    h = x2d @ params["shared_in"]
    g = activation(x2d @ params["shared_gate"], cfg.act)
    return (g * h) @ params["shared_out"]


# ------------------------------------------------------------------ dense ref
def moe_dense_fwd(params, x, cfg: ModelConfig):
    """All experts on all tokens — O(E) flops, tiny-test reference only."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, eids, aux = route(xt, params["router"], cfg)
    xb = xt[None].expand((cfg.moe.n_experts,) + tuple(xt.shape))
    ys = expert_ffn(params["w_in"], params["w_gate"], params["w_out"], xb,
                    cfg.act)
    yk = torch.take_along_dim(ys.transpose(0, 1), eids[..., None], dim=1)
    out = (gates[..., None].to(yk.dtype) * yk).sum(dim=1)
    out = out + _shared(params, xt, cfg)
    return out.reshape(b, s, d).to(x.dtype), aux


# ------------------------------------------------------------------ local
def _dispatch_combine(params, xt, cfg: ModelConfig, with_aux: bool = True):
    """Route xt (T,D), dispatch it into the (E, C, D) expert buffer, run
    every expert, combine.  Returns (combined (T,D), aux)."""
    t, d = xt.shape
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    cap = capacity(t, cfg)
    gates, eids, aux = route(xt, params["router"], cfg, with_aux)
    slot, keep = dispatch_slots(eids, e, cap)
    tok_idx = torch.arange(t * k, device=xt.device) // k
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, slot, xt[tok_idx])
    ys = expert_ffn(params["w_in"], params["w_gate"], params["w_out"],
                    buf[:-1].view(e, cap, d), cfg.act)              # (E,C,D)
    ys_flat = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))])
    yk = ys_flat[slot].view(t, k, d)
    gk = torch.where(keep.view(t, k), gates, torch.zeros_like(gates))
    out = (gk[..., None] * yk.float()).sum(dim=1)
    return out.to(xt.dtype), aux


def moe_local_fwd(params, x, cfg: ModelConfig, with_aux: bool = True):
    """Single-device capacity-dispatch MoE (no collectives)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    out, aux = _dispatch_combine(params, xt, cfg, with_aux)
    out = out + _shared(params, xt, cfg)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_fwd(params, x, cfg: ModelConfig, dist: Optional[object] = None,
            with_aux: bool = True):
    """Entry point: the local path; expert parallelism over a mesh
    (``dist``) is not ported."""
    if dist is not None:
        raise NotImplementedError(
            "expert-parallel MoE (moe_fwd(dist=...)) not ported yet, see "
            "ROADMAP Queue A, \"training and launch tooling\"")
    return moe_local_fwd(params, x, cfg, with_aux)
