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

Expert parallelism (``moe_ep_fwd``, ``moe_fwd(dist=...)``) runs inside a
rank of ``distributed.ranks``: the reference's ``shard_map`` bodies
(``_ep_seq_body``, ``_ep_rep_body``, ``_gather_experts``) take the rank's
context where they name mesh axes.  A rank holds the router and the shared
experts whole and its slice of ``w_in``/``w_gate``/``w_out``: experts
over the tp axis, and with ``fsdp_axis`` d_ff over that axis too
(``distributed.sharding.param_specs(fsdp_experts=True)``, gathered just in
time).  Its ``x`` is its block of the batch over ``dist.dp_axes`` and the
whole sequence, the same on every rank of its model group, and so is its
output.  The aux loss and the capacity are per shard, as the reference's:
the aux is the mean over shards of each shard's Switch loss (``seq``: over
dp and tp; ``rep``: over dp), and C counts a shard's own tokens, so
neither equals the local path's over the same batch.  Gradients follow
``distributed.collectives``' convention: over the model group a
replicated leaf's gradient is whole on every rank and an expert's is its
owner's; over dp they are meaned afterwards.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (all_gather, all_to_all,
                                                 enter, pmean, psum, scatter)
from repro_torch.layers.common import activation, dense_init

# f32 bytes one draw of an expert tensor may take on the generator's device
# (Kimi K2's w_in whole would take 22.5 GB)
INIT_CHUNK_BYTES = 1 << 30


class MeshContext(NamedTuple):
    """Distribution context threaded through model forwards; inside a rank
    ``ranks`` is its ``distributed.ranks.RankContext``."""
    mesh: object                   # launch.mesh.Mesh
    dp_axes: Tuple[str, ...]       # batch-sharding axes, e.g. ("pod","data")
    tp_axis: str                   # tensor/expert-parallel axis, e.g. "model"
    fsdp_axis: Optional[str] = None  # ZeRO-3 axis for expert weights
    ranks: Optional[object] = None

    @property
    def ep_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    @property
    def fsdp_size(self) -> int:
        return self.mesh.shape[self.fsdp_axis] if self.fsdp_axis else 1


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
def _experts_combine(xt, gates, eids, w_in, w_gate, w_out, cfg: ModelConfig,
                     lo: int = 0):
    """Dispatch the (T, k) assignments of xt (T,D) into the (E, C, D)
    expert buffer, run experts [lo, lo + w_in.shape[0]) on their rows,
    combine.  With fewer than E experts (rep-EP) only assignments to those
    are kept: the rank's partial output."""
    t, d = xt.shape
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    e_local = w_in.shape[0]
    cap = capacity(t, cfg)
    slot, keep = dispatch_slots(eids, e, cap)
    if e_local != e:
        keep = keep & (eids.reshape(-1) // e_local == lo // e_local)
        slot = torch.where(keep, slot, torch.full_like(slot, e * cap))
    tok_idx = torch.arange(t * k, device=xt.device) // k
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, slot, xt[tok_idx])
    xb = buf[:-1].view(e, cap, d)
    if e_local != e:
        xb = xb[lo:lo + e_local]
    ys = expert_ffn(w_in, w_gate, w_out, xb, cfg.act)              # (El,C,D)
    if e_local != e:
        ys = torch.cat([ys.new_zeros((lo, cap, d)), ys,
                        ys.new_zeros((e - lo - e_local, cap, d))])
    return _combine(ys, slot, keep, gates, xt.dtype)


def _combine(ys, slot, keep, gates, dtype):
    """sum_k gate_k * ys[slot_k] over the kept assignments, in f32."""
    e, cap, d = ys.shape
    t, k = gates.shape
    ys_flat = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))])
    yk = ys_flat[slot].view(t, k, d)
    gk = torch.where(keep.view(t, k), gates, torch.zeros_like(gates))
    return (gk[..., None] * yk.float()).sum(dim=1).to(dtype)


def _dispatch_combine(params, xt, cfg: ModelConfig, with_aux: bool = True):
    """Route xt (T,D), dispatch it into the (E, C, D) expert buffer, run
    every expert, combine.  Returns (combined (T,D), aux)."""
    gates, eids, aux = route(xt, params["router"], cfg, with_aux)
    out = _experts_combine(xt, gates, eids, params["w_in"],
                           params["w_gate"], params["w_out"], cfg)
    return out, aux


def moe_local_fwd(params, x, cfg: ModelConfig, with_aux: bool = True):
    """Single-device capacity-dispatch MoE (no collectives)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    out, aux = _dispatch_combine(params, xt, cfg, with_aux)
    out = out + _shared(params, xt, cfg)
    return out.reshape(b, s, d).to(x.dtype), aux


# ------------------------------------------------------------------ EP
_REPLICATED = ("router", "shared_in", "shared_gate", "shared_out")


def _gather_experts(params, ctx, fsdp_axis):
    """ZeRO-3: expert weights arrive d_ff-sharded over fsdp_axis; gather
    them just in time (storage stays sharded, compute sees whole experts;
    each shard's gradient is the data-parallel mean of the whole one's
    slice)."""
    if not fsdp_axis:
        return params
    p = dict(params)
    p["w_in"] = all_gather(params["w_in"], ctx, fsdp_axis, dim=2, tiled=True)
    p["w_gate"] = all_gather(params["w_gate"], ctx, fsdp_axis, dim=2,
                             tiled=True)
    p["w_out"] = all_gather(params["w_out"], ctx, fsdp_axis, dim=1,
                            tiled=True)
    return p


def _ep_seq_body(params, x, cfg: ModelConfig, ctx, dp_axes, tp_axis,
                 fsdp_axis=None, with_aux: bool = True):
    """Per-rank body, tokens sequence-sharded over tp_axis: the rank's
    slice of x (Bl, S, D) is routed and dispatched into (E, C, D), every
    expert's rows go to its owner (``all_to_all``), the owner runs its
    E/ep experts over the rows of every peer and sends them back, and the
    rank combines its slice; the slices are gathered along the sequence so
    that the output, like x, is the same on every rank of the group."""
    params = _gather_experts(params, ctx, fsdp_axis)
    # replicated leaves enter the rank's own slice of the work
    rep = {k: enter(params[k], ctx, tp_axis)
           for k in _REPLICATED if k in params}
    xs = scatter(x, ctx, tp_axis, dim=1)
    bl, sl, d = xs.shape
    xt = xs.reshape(-1, d)
    t = xt.shape[0]
    m = cfg.moe
    ep = ctx.size(tp_axis)
    e_global, e_local = m.n_experts, m.n_experts // ep
    cap = capacity(t, cfg)
    gates, eids, aux = route(xt, rep["router"], cfg, with_aux)
    slot, keep = dispatch_slots(eids, e_global, cap)
    tok_idx = torch.arange(t * m.top_k, device=xt.device) // m.top_k
    buf = xt.new_zeros((e_global * cap + 1, d))
    buf.index_copy_(0, slot, xt[tok_idx])
    # exchange: (E, C, D) -> rows regrouped so this rank holds its
    # experts' tokens from every peer: (ep*E_local, C, D), blocks
    # [peer, local_e]
    buf = all_to_all(buf[:-1].view(e_global, cap, d), ctx, tp_axis)
    xb = buf.view(ep, e_local, cap, d).transpose(0, 1)
    xb = xb.reshape(e_local, ep * cap, d)
    ys = expert_ffn(params["w_in"], params["w_gate"], params["w_out"], xb,
                    cfg.act)
    ys = ys.view(e_local, ep, cap, d).transpose(0, 1)
    ys = all_to_all(ys.reshape(e_global, cap, d), ctx, tp_axis)
    out = _combine(ys, slot, keep, gates, xt.dtype)
    out = out + _shared(rep, xt, cfg)
    out = all_gather(out.view(bl, sl, d), ctx, tp_axis, dim=1, tiled=True)
    if aux is not None:
        aux = pmean(aux, ctx, tuple(dp_axes) + (tp_axis,))
    return out, aux


def _ep_rep_body(params, x, cfg: ModelConfig, ctx, dp_axes, tp_axis,
                 fsdp_axis=None, with_aux: bool = True):
    """Per-rank body, tokens replicated over tp_axis: every rank routes
    all of x (Bl, S, D), dispatches only to its own E/ep experts, and the
    partial outputs are summed over the group; the shared experts are
    added once, after the sum."""
    params = _gather_experts(params, ctx, fsdp_axis)
    bl, s, d = x.shape
    xt = x.reshape(-1, d)
    ep = ctx.size(tp_axis)
    e_local = cfg.moe.n_experts // ep
    gates, eids, aux = route(xt, params["router"], cfg, with_aux)
    # the replicated tokens and gates enter the rank's own experts' work
    out = _experts_combine(enter(xt, ctx, tp_axis),
                           enter(gates, ctx, tp_axis), eids, params["w_in"],
                           params["w_gate"], params["w_out"], cfg,
                           lo=ctx.index(tp_axis) * e_local)
    out = psum(out, ctx, tp_axis)
    # shared experts once (identical on every rank: no psum)
    out = out + _shared(params, xt, cfg)
    if aux is not None and dp_axes:
        aux = pmean(aux, ctx, tuple(dp_axes))
    return out.reshape(bl, s, d), aux


def effective_dp_axes(dist: MeshContext, batch: int) -> tuple:
    """The reference's rule for the axes a global batch of ``batch`` rows
    splits over: the longest prefix of ``dist.dp_axes`` whose product
    divides it (decode at batch 1 runs replicated over dp).  The caller
    lays out each rank's rows by it and passes it as ``dp_axes``."""
    dp, prod = [], 1
    for a in dist.dp_axes:
        if batch % (prod * dist.mesh.shape[a]) == 0:
            dp.append(a)
            prod *= dist.mesh.shape[a]
    return tuple(dp)


def moe_ep_fwd(params, x, cfg: ModelConfig, dist: MeshContext,
               mode: str = "auto", with_aux: bool = True):
    """Expert-parallel MoE inside a rank (``dist.ranks``).  x: the rank's
    (Bl, S, D) block over ``dist.dp_axes``; ``mode`` "seq" (S split over
    the tp axis, ``all_to_all``), "rep" (S whole, a ``psum``) or "auto"
    ("seq" when S divides by ep).  Returns (out (Bl, S, D), aux)."""
    ctx = dist.ranks
    if ctx is None:
        raise ValueError("moe_ep_fwd runs inside a rank "
                         "(distributed.ranks): dist.ranks is None")
    if mode == "auto":
        mode = "seq" if x.shape[1] % dist.ep_size == 0 else "rep"
    if mode not in ("seq", "rep"):
        raise ValueError(f"unknown EP mode {mode!r}: seq, rep or auto")
    fsdp = dist.fsdp_axis
    if fsdp and (cfg.moe.d_expert % dist.fsdp_size or
                 cfg.moe.n_experts % dist.ep_size):
        fsdp = None          # the experts then stay whole in d_ff
    body = _ep_seq_body if mode == "seq" else _ep_rep_body
    out, aux = body(params, x, cfg, ctx, tuple(dist.dp_axes), dist.tp_axis,
                    fsdp, with_aux)
    return out.to(x.dtype), aux


def moe_fwd(params, x, cfg: ModelConfig, dist: Optional[MeshContext] = None,
            mode: str = "auto", with_aux: bool = True):
    """Entry point: EP when a mesh context is given, local otherwise."""
    if dist is None:
        return moe_local_fwd(params, x, cfg, with_aux)
    return moe_ep_fwd(params, x, cfg, dist, mode=mode, with_aux=with_aux)
