"""Step builders: per-rank train, prefill and decode steps over a
(pod, data, model) mesh, their input specs, and abstract parameters.

Counterpart of ``repro/launch/steps.py``.  The reference jits one step
body and lets GSPMD place it by its ``in_shardings`` (``param_specs``,
``_opt_specs``, ``batch_pspecs``, ``cache_specs``) and its activation
hook (``make_shd``).  The port has no GSPMD: ``build_step`` returns a
``StepBundle`` whose ``fn(ctx, *shards)`` is ONE rank's body, written
against the rank's context (``distributed.ranks.RankContext``) and the
port's collectives (``distributed.collectives``), holding its leaves by
the reference's specs.  ``bundle.run(pool, inputs)`` runs it over the
ranks of a ``RankPool``; ``launch.dryrun`` traces one rank's body on fake
tensors with a dry context, the counterpart of the reference's
``lower()``.  Inputs are global trees (``bundle.in_specs`` gives their
shapes and dtypes as meta tensors, the counterpart of ``in_sds``);
``bundle.rank_inputs(inputs, r)`` is rank r's slices of them.

What the rank body does in place of GSPMD (``RankTP``, the forward's
``tp`` hook):

* attention heads (q by ``n_heads``, k/v by ``n_kv_heads``), the dense
  MLP's d_ff, Mamba's d_inner (``in_proj``'s x and z columns, ``conv_w``,
  ``dt_w``, ``x_proj`` and ``out_proj`` rows) and RWKV-6's heads and
  channel-mix d_ff run Megatron tensor parallelism over the model axis
  where the specs split them: the region's input enters through
  ``collectives.enter`` and its output leaves through ``psum``, so the
  backward is right.  With q heads split and k/v whole (their count does
  not divide), the rank reads the kv heads its queries use (``kv_sel``);
* the vocabulary is split where ``embed`` / ``lm_head`` are: a masked
  lookup plus a ``psum``, the logits the rank's vocabulary block (the
  reference's ``out_shardings`` ``P(dp, None, "model")``) and the CE
  vocabulary-parallel (the row max and the log-sum-exp over the model
  axis);
* the experts run expert-parallel (``layers.moe.moe_ep_fwd``) with
  ``fsdp_experts`` from ``needs_fsdp``;
* any other leaf the specs split and no rule above consumes (the shared
  experts, the encoder, the cross-attention when its heads do not
  split) is gathered whole before use, its gradient the rank's slice:
  those layers' per-rank FLOPs are whole;
* with ``seq_shard`` the residual stream between superblocks is the
  rank's block of S (gathered at a superblock's entry, sliced at its
  exit), so the boundaries a remat keeps are 1/tp of the stream;
* a KV cache split along T (``cache_specs``' fallback) is written where
  a position falls and read by a partial softmax combined over the model
  axis (``layers.attention``); RWKV-6's recurrence is over-sharded over
  the batch as the reference's ``wkv`` hook asks;
* the train step's gradients are meaned exactly over ``pod`` x ``data``;
  each rank updates its ZeRO-1 slice of the optimizer state (the leading
  dim over ``data``) and all-gathers the new parameters; ``microbatches``
  > 1 sums f32 gradients over the rank's microbatches and divides.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    _at, _tree_map, cache_specs, make_shd, param_specs, shard_for_rank,
    valid_spec)
from repro_torch.launch.mesh import dp_axes_of, tp_axis_of
from repro_torch.layers.common import embed_tokens, softcap
from repro_torch.layers.moe import MeshContext
from repro_torch.models import (forward, init_params, layer_kind, loss_fn,
                                make_cache)
from repro_torch.training.optim import (OptConfig, adafactor_update,
                                       adamw_update, opt_init)
from repro_torch.tree import leaves, map_tree, named_leaves


# ------------------------------------------------------------ input specs
def encoder_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Source-sequence length for enc-dec / VLM stubs."""
    if cfg.n_encoder_layers or cfg.frontend != "none":
        return cfg.n_frontend_tokens
    return 0


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _enc_specs(cfg: ModelConfig, b: int, el: int) -> dict:
    if cfg.n_encoder_layers:
        return {"encoder_tokens": _meta((b, el, cfg.d_model), cfg.cdtype)}
    if cfg.frontend == "vision_patches":
        return {"frontend_embeds": _meta((b, el, cfg.d_model), cfg.cdtype)}
    return {}


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for one global batch of this shape cell."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), torch.int32),
           "labels": _meta((b, s), torch.int32)}
    out.update(_enc_specs(cfg, b, encoder_len(cfg, shape)))
    return out


def batch_pspecs(batch, mesh) -> dict:
    dp = dp_axes_of(mesh)
    return {k: valid_spec(x.shape, (dp,) + (None,) * (x.dim() - 1), mesh)
            for k, x in batch.items()}


def params_sds(cfg: ModelConfig) -> dict:
    """The model's parameter tree on the meta device: shaped and typed as
    ``init_params`` makes it, with no draw and no storage."""
    return init_params(cfg, torch.Generator(), device="meta")


@dataclass(frozen=True)
class StepOptions:
    """Perf/memory levers, as the reference's but for ``donate``: a step
    always updates its parameters, optimizer state and caches in place."""
    microbatches: int = 0          # 0 = auto (fit activation budget)
    seq_shard: bool = True         # Megatron-style sequence-parallel residuals
    remat_policy: str = "nothing"  # nothing | dots | dots_no_batch
    loss_chunks: int = 0           # 0 = auto (vocab-dependent)
    zero1: bool = True             # shard optimizer state over data axis
    act_budget_bytes: float = 4e9  # per-device activation target for auto-µb


def default_options(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    base: Optional[StepOptions] = None) -> StepOptions:
    """Napkin-math defaults: pick microbatches so remat-saved layer
    boundaries (B_loc x S_loc x D x 2B x n_layers) fit the budget."""
    opt = base or StepOptions()
    dp = math.prod(mesh.shape[a] for a in dp_axes_of(mesh))
    tp = mesh.shape["model"]
    if shape.kind != "train":
        return dataclasses.replace(opt, microbatches=1,
                                   loss_chunks=opt.loss_chunks or 1)
    b_loc = max(shape.global_batch // dp, 1)
    s_loc = shape.seq_len // tp if (opt.seq_shard and
                                    shape.seq_len % tp == 0) \
        else shape.seq_len
    total = b_loc * s_loc * cfg.d_model * 2 * cfg.n_layers
    mb = opt.microbatches
    if mb == 0:
        mb = 1
        while total / mb > opt.act_budget_bytes and mb < b_loc:
            mb *= 2
        mb = min(mb, b_loc)
    lc = opt.loss_chunks
    if lc == 0:
        lc = 8 if cfg.vocab_size >= 100_000 else 1
        while shape.seq_len % max(lc, 1):
            lc //= 2
        lc = max(lc, 1)
    return dataclasses.replace(opt, microbatches=mb, loss_chunks=lc)


FSDP_THRESHOLD_BYTES = 10e9


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def needs_fsdp(cfg: ModelConfig, mesh, p_sds=None) -> bool:
    """TP-sharded params exceed the per-device budget -> ZeRO-3 the
    experts."""
    if cfg.moe is None:
        return False
    p_sds = p_sds if p_sds is not None else params_sds(cfg)
    return _nbytes(p_sds) / mesh.shape["model"] > FSDP_THRESHOLD_BYTES


def _axes_in(spec) -> set:
    return {a for e in spec if e
            for a in ((e,) if isinstance(e, str) else e)}


def _opt_specs(opt_sds, p_specs, mesh, zero1: bool) -> dict:
    """Optimizer-state specs mirror param specs; ZeRO-1 additionally
    shards the leading dim over the data axis (AdamW's ``m``/``v``,
    Adafactor's unfactored ``v``; its ``vr``/``vc`` drop the parameter
    spec's last / second-to-last entry)."""
    def mirror(leaf, spec):
        spec = (list(spec) + [None] * leaf.dim())[:leaf.dim()]
        if zero1 and "data" not in _axes_in(spec) and spec \
                and spec[0] is None \
                and leaf.shape[0] % mesh.shape["data"] == 0:
            spec = ["data"] + spec[1:]
        return valid_spec(leaf.shape, tuple(spec), mesh)

    def spec_v(path, sub):
        ps = list(_at(p_specs, path))
        if isinstance(sub, dict):
            out = {}
            if "vr" in sub:
                out["vr"] = valid_spec(sub["vr"].shape, tuple(ps[:-1]), mesh)
                out["vc"] = valid_spec(sub["vc"].shape,
                                       tuple(ps[:-2] + ps[-1:]), mesh)
            if "v" in sub:
                out["v"] = mirror(sub["v"], ps)
            return out
        return mirror(sub, ps)

    out = {}
    for k, v in opt_sds.items():
        if k == "step":
            out[k] = ()
        elif k == "m":
            out[k] = _tree_map(lambda p, x: mirror(x, _at(p_specs, p)), v)
        elif k == "v":
            out[k] = _map_states(spec_v, v)
        else:
            out[k] = _tree_map(lambda p, x: (None,) * x.dim(), v)
    return out


def _map_states(fn, tree, path=()):
    """``fn(path, sub)`` where ``sub`` is a leaf or an Adafactor state
    dict ({"vr", "vc"} or {"v"})."""
    if isinstance(tree, dict) and not set(tree) <= {"vr", "vc", "v"}:
        return {k: _map_states(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_states(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _zip_map(fn, trees):
    """``fn(*leaves)`` over trees of one structure (dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_zip_map(fn, [t[i] for t in trees])
                for i in range(len(first))]
    return fn(*trees)


_STACKED = ("blocks", "enc_blocks")


def _periods(cfg: ModelConfig) -> dict:
    return {"blocks": len(cfg.block_pattern), "enc_blocks": 1}


def stack_blocks(tree, cfg: ModelConfig, fn=None) -> dict:
    """A per-layer tree (parameters, gradients, specs) in the
    reference's layout: ``blocks`` (and ``enc_blocks``) as {"slot{j}":
    leaves stacked on a leading superblock dim}, superblock-major, then
    slot, as ``bridge.params_from_jax`` unstacks them; other keys as they
    are.  ``fn(*leaves)`` joins one slot's leaves (default
    ``torch.stack``)."""
    fn = fn or (lambda *xs: torch.stack(xs))
    out = {}
    for key, val in tree.items():
        if key not in _STACKED:
            out[key] = val
            continue
        period = _periods(cfg)[key]
        n_sb = len(val) // period
        out[key] = {f"slot{j}": _zip_map(fn, [val[sb * period + j]
                                              for sb in range(n_sb)])
                    for j in range(period)}
    return out


def stack_specs(p_specs, cfg: ModelConfig) -> dict:
    """``param_specs`` in the stacked layout: a slot's spec with the
    superblock dim (replicated) in front."""
    return stack_blocks(p_specs, cfg, lambda *sp: (None,) + tuple(sp[0]))


def _unstack_into(params, stacked, cfg: ModelConfig) -> None:
    """Copy the stacked tree's block leaves back into ``params``'s."""
    for key in _STACKED:
        if key not in params:
            continue
        period = _periods(cfg)[key]
        for i, layer in enumerate(params[key]):
            sb, j = divmod(i, period)
            _zip_map(lambda dst, src, sb=sb: dst.copy_(src[sb]),
                     [layer, stacked[key][f"slot{j}"]])


def opt_sds(opt_cfg: OptConfig, p_sds, cfg: ModelConfig) -> dict:
    """The optimizer state of ``p_sds`` (meta tensors), in the
    reference's stacked layout (``stack_blocks``): its ZeRO-1 slice over
    "data" is then the reference's, whole superblocks a rank."""
    state = opt_init(opt_cfg, stack_blocks(p_sds, cfg))
    state["step"] = _meta((), torch.int32)
    return state


# ------------------------------------------------------------ the plan
def _split(spec, axis: str = "model") -> Optional[int]:
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_RWKV_HEAD = ("u", "ln_scale", "ln_bias")        # (H, hd)
_RWKV_FLAT = ("w0",)                             # (H*hd,)
_MAMBA_VEC = ("conv_b", "dt_b", "D")             # (di,)


@dataclass(frozen=True)
class Plan:
    """What every rank of a bundle needs besides its tensors: the config
    (global and the rank's head counts), the mesh, the specs of the
    inputs and which regions run tensor-parallel."""
    kind: str                      # train | prefill | decode
    cfg: ModelConfig
    local_cfg: ModelConfig
    mesh: object
    options: StepOptions
    opt_cfg: Optional[OptConfig]
    specs: tuple                   # the inputs' spec trees, positional
    fsdp: bool
    partial: dict                  # region kind -> output is a partial sum
    vocab_split: bool
    group: int                     # q heads a kv head serves (kv whole)
    seq_shard: bool
    wkv_batch: bool                # RWKV's recurrence over-sharded on tp
    seq_cache: bool                # the KV cache split along T
    cross_seq: bool                # the cross cache split along T


def _first(specs_blocks, part: str, names) -> Optional[tuple]:
    for bp in specs_blocks:
        sub = bp.get(part)
        if isinstance(sub, dict):
            for n in names:
                if n in sub:
                    return sub[n]
    return None


def make_plan(kind: str, cfg: ModelConfig, shape: ShapeSpec, mesh,
              options: StepOptions, opt_cfg, specs: tuple, fsdp: bool,
              cache_spec_tree=None) -> Plan:
    tp = mesh.shape["model"]
    p_specs = specs[0]
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q_split = hq % tp == 0
    kv_split = hkv % tp == 0
    hq_loc = hq // tp if q_split else hq
    g = hq // hkv
    partial = {}
    blocks = p_specs["blocks"]
    kinds = set(cfg.block_pattern)
    attn_ok = q_split and (kv_split or g % hq_loc == 0 or hq_loc % g == 0)
    multi = tp > 1

    def split_at(part, names, present=True):
        spec = _first(blocks, part, names) if present else None
        return multi and spec is not None and _split(spec) is not None

    for k in ("attn", "attn_local", "xattn"):
        partial[k] = multi and attn_ok
    partial["mlp"] = split_at("mlp", ("w_out", "wv"))
    partial["mamba"] = split_at("mixer", ("out_proj",), "mamba" in kinds)
    partial["rwkv6"] = split_at("mixer", ("wr",), "rwkv6" in kinds)
    if "rwkv6" in kinds and kinds & {"attn", "attn_local", "xattn"} and \
            partial["rwkv6"] != partial["attn"]:
        # one local head count serves both kinds: split neither
        for k in ("attn", "attn_local", "xattn", "rwkv6"):
            partial[k] = False
    partial["moe"] = False
    vocab_split = multi and _split(p_specs["embed"]) is not None
    partial["head"] = vocab_split
    heads_split = partial["attn"] or partial["rwkv6"]
    local_cfg = cfg.replace(
        n_heads=hq_loc if heads_split else hq,
        n_kv_heads=hkv // tp if (heads_split and kv_split) else hkv,
        head_dim=cfg.hd)
    dp = dp_axes_of(mesh)
    seq = bool(options.seq_shard) and kind in ("train", "prefill") \
        and tp > 1 and shape.seq_len % tp == 0
    shd = make_shd(mesh, dp=dp, tp="model", seq_shard=seq)
    wkv_spec = shd("wkv", (shape.global_batch, shape.seq_len, hq, cfg.hd))
    wkv_batch = "rwkv6" in kinds and not partial["rwkv6"] and tp > 1 and \
        "model" in _axes_in(wkv_spec[:1])
    seq_cache = cross_seq = False
    for layer in cache_spec_tree or ():
        seq_cache |= "k" in layer and _split(layer["k"]) == 1
        cross_seq |= "cross_k" in layer and _split(layer["cross_k"]) == 1
    return Plan(kind=kind, cfg=cfg, local_cfg=local_cfg, mesh=mesh,
                options=options, opt_cfg=opt_cfg, specs=specs, fsdp=fsdp,
                partial=partial, vocab_split=vocab_split,
                group=g, seq_shard=seq, wkv_batch=wkv_batch,
                seq_cache=seq_cache, cross_seq=cross_seq)


# ------------------------------------------------------------ rank hooks
class _SeqSplit:
    """A KV cache split along T over the model axis, for
    ``layers.attention``."""

    def __init__(self, tp: "RankTP", n: int):
        self.tp, self.n = tp, n
        self.lo = tp.index * n

    def all_heads(self, q):
        if not self.tp.plan.partial["attn"]:
            return q
        return coll.all_gather(q, self.tp.ctx, "model", dim=2, tiled=True)

    def own_heads(self, o):
        if not self.tp.plan.partial["attn"]:
            return o
        n = o.shape[2] // self.tp.size
        return o[:, :, self.tp.index * n:(self.tp.index + 1) * n]

    def pmax(self, m):
        return coll.all_gather(m, self.tp.ctx, "model").amax(dim=0)

    def psum(self, x):
        return coll.psum(x, self.tp.ctx, "model")

    def gather_positions(self, leaf):
        return coll.all_gather(leaf, self.tp.ctx, "model", dim=1, tiled=True)


class _Wkv:
    """RWKV-6's recurrence: the batch over-shard (``batch``) and, with the
    heads split, the rank's heads of a whole cache state (``heads``)."""

    def __init__(self, tp: "RankTP", batch: bool, heads: Optional[slice]):
        self.tp, self.batch, self.heads = tp, batch, heads

    def split(self, t):
        return coll.scatter(t, self.tp.ctx, "model", 0) if self.batch else t

    def join(self, t):
        if not self.batch:
            return t
        return coll.all_gather(t, self.tp.ctx, "model", dim=0, tiled=True)

    def state_in(self, s):
        return s if self.heads is None else s[:, self.heads]

    def state_out(self, s):
        if self.heads is None:
            return s
        return coll.all_gather(s, self.tp.ctx, "model", dim=1, tiled=True)


class RankTP:
    """One rank's tensor-parallel hooks for ``models.forward`` (its
    ``tp=``): see the module's docstring."""

    def __init__(self, plan: Plan, ctx, cache=None):
        self.plan, self.ctx = plan, ctx
        self.size = ctx.size("model")
        self.index = ctx.index("model")
        self.seq_shard = plan.seq_shard
        lc = plan.local_cfg
        self.kv_sel = None
        if plan.partial["attn"] and lc.n_kv_heads == plan.cfg.n_kv_heads \
                and self.size > 1:
            lo = self.index * lc.n_heads
            hi = lo + lc.n_heads
            self.kv_sel = slice(lo // plan.group, (hi - 1) // plan.group + 1)
        self.seq_split = self.cross_split = None
        if plan.seq_cache and cache is not None:
            first = next(layer for layer in cache if "k" in layer)
            self.seq_split = _SeqSplit(self, first["k"].shape[1])
        if plan.cross_seq and cache is not None:
            first = next(layer for layer in cache if "cross_k" in layer)
            self.cross_split = _SeqSplit(self, first["cross_k"].shape[1])
        heads = None
        if plan.partial["rwkv6"]:
            heads = slice(self.index * lc.n_heads,
                          (self.index + 1) * lc.n_heads)
        self.wkv = _Wkv(self, plan.wkv_batch, heads) \
            if "rwkv6" in plan.cfg.block_pattern else None

    def partial(self, kind: str) -> bool:
        return self.plan.partial.get(kind, False)

    def enter(self, t):
        return coll.enter(t, self.ctx, "model")

    def reduce(self, name: str, y):
        return coll.psum(y, self.ctx, "model")

    def seq_gather(self, x):
        return coll.all_gather(x, self.ctx, "model", dim=1, tiled=True)

    def seq_scatter(self, x):
        return coll.scatter(x, self.ctx, "model", 1)

    def embed(self, table, tokens, cfg: ModelConfig):
        if not self.plan.vocab_split:
            return embed_tokens(table, tokens, cfg)
        n = table.shape[0]
        ids = tokens.long() - self.index * n
        inside = (ids >= 0) & (ids < n)
        x = table[ids.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
        x = coll.psum(x, self.ctx, "model")
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def logits(self, x, params, cfg: ModelConfig):
        """The rank's vocabulary block of the logits (f32, soft-capped)."""
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        if self.plan.vocab_split:
            x = self.enter(x)
        return softcap((x @ w.to(x.dtype)).float(), cfg.final_softcap)

    def ce_sum(self, logits, labels):
        """Sum over tokens of logsumexp - logits[label] over the whole
        vocabulary, from each rank's block."""
        if not self.plan.vocab_split:
            gold = logits.gather(-1, labels[..., None])[..., 0]
            return (torch.logsumexp(logits, dim=-1) - gold).sum()
        n = logits.shape[-1]
        top = coll.all_gather(logits.detach().amax(dim=-1), self.ctx,
                              "model").amax(dim=0)
        se = coll.psum(torch.exp(logits - top[..., None]).sum(dim=-1),
                       self.ctx, "model")
        ids = labels - self.index * n
        inside = (ids >= 0) & (ids < n)
        gold = logits.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
        gold = coll.psum(gold * inside, self.ctx, "model")
        return (top + torch.log(se) - gold).sum()


# ------------------------------------------------------------ working tree
def _gather(t, ctx, spec):
    d = _split(spec)
    return coll.all_gather(t, ctx, "model", dim=d, tiled=True)


def working_params(held, plan: Plan, tp: RankTP):
    """The tree the rank's forward reads, from its held slices: a slice
    a tensor-parallel region consumes as it is; a replicated leaf a
    partial region uses entered (its gradient summed over the model
    axis), sliced to the rank's heads or d_inner where the region reads
    only those; any other split leaf gathered whole."""
    specs = plan.specs[0]
    part = plan.partial
    ctx = tp.ctx
    if tp.size == 1:
        return held
    lc = plan.local_cfg

    def block(b: dict, bs: dict, kind: str, encoder: bool) -> dict:
        out = {}
        for name, sub in b.items():
            ss = bs[name]
            if not isinstance(sub, dict):
                out[name] = sub
                continue
            if encoder or name in ("norm1", "norm2", "norm_x"):
                out[name] = {k: (_gather(v, ctx, ss[k]) if _split(ss[k])
                                 is not None else v) for k, v in sub.items()}
            elif name == "moe":
                out[name] = {k: (v if k in ("w_in", "w_gate", "w_out",
                                            "router")
                                 or _split(ss[k]) is None
                                 else _gather(v, ctx, ss[k]))
                             for k, v in sub.items()}
            elif name == "mlp":
                ok = part["mlp"]
                out[name] = {k: (v if _split(ss[k]) is not None
                                 else tp.enter(v) if ok else v)
                             for k, v in sub.items()}
            elif kind == "mamba":
                out[name] = _mamba_work(sub, ss, tp, part["mamba"])
            elif kind == "rwkv6":
                out[name] = _rwkv_work(sub, ss, tp, part["rwkv6"], lc)
            else:
                ok = part["xattn" if name == "xattn" else kind]
                out[name] = {k: (v if ok and _split(ss[k]) is not None
                                 else _gather(v, ctx, ss[k])
                                 if _split(ss[k]) is not None
                                 else tp.enter(v) if ok else v)
                             for k, v in sub.items()}
        return out

    work = {}
    for key, val in held.items():
        spec = specs[key]
        if key == "blocks":
            work[key] = [block(b, spec[i], layer_kind(plan.cfg, i), False)
                         for i, b in enumerate(val)]
        elif key == "enc_blocks":
            work[key] = [block(b, spec[i], "attn", True)
                         for i, b in enumerate(val)]
        elif key in ("embed", "lm_head"):
            work[key] = val
        else:
            work[key] = val
    return work


def _mamba_work(sub, ss, tp: RankTP, ok: bool) -> dict:
    if not ok:
        return {k: (_gather(v, tp.ctx, ss[k]) if _split(ss[k]) is not None
                    else v) for k, v in sub.items()}
    out = {}
    di = sub["conv_w"].shape[1]                      # the rank's d_inner
    lo = tp.index * di
    for k, v in sub.items():
        if k == "in_proj":
            whole = tp.enter(_gather(v, tp.ctx, ss[k]))
            half = whole.shape[1] // 2
            out[k] = torch.cat([whole[:, lo:lo + di],
                                whole[:, half + lo:half + lo + di]], dim=1)
        elif k in _MAMBA_VEC:
            out[k] = tp.enter(v)[lo:lo + di]
        else:
            out[k] = v
    return out


def _rwkv_work(sub, ss, tp: RankTP, ok: bool, lc: ModelConfig) -> dict:
    if not ok:
        return {k: (_gather(v, tp.ctx, ss[k]) if _split(ss[k]) is not None
                    else v) for k, v in sub.items()}
    h = lc.n_heads
    heads = slice(tp.index * h, (tp.index + 1) * h)
    cols = slice(tp.index * h * lc.hd, (tp.index + 1) * h * lc.hd)
    out = {}
    for k, v in sub.items():
        if _split(ss[k]) is not None:
            out[k] = v
        elif k in _RWKV_HEAD:
            out[k] = tp.enter(v)[heads]
        elif k in _RWKV_FLAT:
            out[k] = tp.enter(v)[cols]
        elif k == "wB":
            out[k] = tp.enter(v)[:, cols]
        else:
            out[k] = tp.enter(v)
    return out


def _mesh_ctx(plan: Plan, ctx) -> MeshContext:
    return MeshContext(mesh=plan.mesh, dp_axes=dp_axes_of(plan.mesh),
                       tp_axis=tp_axis_of(plan.mesh),
                       fsdp_axis="data" if plan.fsdp else None, ranks=ctx)


# ------------------------------------------------------------ rank bodies
def _leaf_mean_axes(plan: Plan, spec) -> tuple:
    """The data-parallel axes a leaf's gradient is still to be meaned
    over: those its spec does not split (a split one's gather already
    reduced its gradient over them)."""
    used = _axes_in(spec)
    return tuple(a for a in dp_axes_of(plan.mesh) if a not in used)


def _global_norm(plan: Plan, ctx, grads) -> torch.Tensor:
    """The global gradient norm from the rank's slices: each leaf's
    squares summed over the axes its spec splits."""
    specs = dict(_named_specs(plan.specs[0]))
    groups: dict = {}
    for key, g in named_leaves(grads):
        axes = tuple(a for a in plan.mesh.shape
                     if a in _axes_in(specs[key]))
        sq = g.float().square().sum()
        groups[axes] = groups.get(axes, 0) + sq
    total = torch.zeros((), dtype=torch.float32, device=ctx.device)
    for axes, sq in groups.items():
        total = total + (coll.raw_psum(sq, ctx, axes) if axes else sq)
    return total.sqrt()


def _named_specs(tree, prefix: str = ""):
    """(key, spec) of every leaf of a spec tree (specs are tuples)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_specs(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_specs(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _zero1_slices(plan: Plan, ctx, params, grads):
    """Stacked (params, grads) as the rank's ZeRO-1 slices (views along
    dim 0 where the optimizer state's spec adds "data"), and the keys
    sliced."""
    adamw = "m" in plan.specs[1]
    o_specs = dict(_named_specs(plan.specs[1]["m" if adamw else "v"]))
    p_specs = dict(_named_specs(stack_specs(plan.specs[0], plan.cfg)))
    n = plan.mesh.shape["data"]
    i = ctx.index("data")
    sliced = set()

    def cut(key, t):
        os_ = o_specs.get(key if adamw else f"{key}/v")
        if not os_ or "data" not in _axes_in(os_[:1]) or \
                "data" in _axes_in(p_specs[key][:1]):
            return t
        sliced.add(key)
        m = t.shape[0] // n
        return t[i * m:(i + 1) * m]

    return _keyed_map(cut, params), _keyed_map(cut, grads), sliced


def _keyed_map(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _keyed_map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keyed_map(fn, v, f"{prefix}{i}/") for i, v in
                enumerate(tree)]
    return fn(prefix[:-1], tree)


def _sharded_mean(plan: Plan, ctx, sliced: set):
    """Adafactor's statistics over every rank's slice of a (stacked)
    leaf."""
    p_specs = dict(_named_specs(stack_specs(plan.specs[0], plan.cfg)))

    def mean(t, dim, key, pdim):
        spec = list(p_specs[key])
        if key in sliced:
            spec[0] = "data"
        nd = len(spec)
        dims = range(nd) if pdim is None else [pdim % nd]
        axes = tuple(a for a in plan.mesh.shape
                     if any(a in _axes_in((spec[d],)) for d in dims))
        if dim is None:
            s, count = t.sum(), t.numel()
        else:
            s, count = t.sum(dim=dim), t.shape[dim]
        if axes:
            s = coll.raw_psum(s.contiguous(), ctx, axes)
            count *= ctx.size(axes)
        return s / count
    return mean


def train_body(plan: Plan, ctx, params, opt_state, batch):
    """One rank's train step: returns (params, opt_state, metrics), the
    parameters and the state updated in place."""
    tp = RankTP(plan, ctx)
    cfg = plan.local_cfg
    held = map_tree(lambda t: t.detach().requires_grad_(), params)
    flat = leaves(held)
    mb = max(plan.options.microbatches, 1)
    rows = batch["tokens"].shape[0]
    if rows % mb:
        raise ValueError(f"{rows} rows a rank do not split into {mb} "
                         "microbatches")
    n = rows // mb
    dist = _mesh_ctx(plan, ctx)
    grads, sums = None, 0.0
    for j in range(mb):
        part = {k: v[j * n:(j + 1) * n] for k, v in batch.items()}
        work = working_params(held, plan, tp)
        loss, (ce, aux) = loss_fn(
            work, part, cfg, remat=True,
            remat_policy=plan.options.remat_policy,
            loss_chunks=plan.options.loss_chunks, dist=dist, tp=tp)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for g, t in zip(gs, flat)]
        if mb == 1:
            grads = gs
        elif grads is None:
            grads = [g.float() for g in gs]
        else:
            grads = [a + b.float() for a, b in zip(grads, gs)]
        sums = sums + torch.stack([loss.detach(), ce.detach(),
                                   aux.detach()]).float()
    if mb > 1:
        grads = [g / mb for g in grads]
    sums = sums / mb
    specs = dict(_named_specs(plan.specs[0]))
    keys = [k for k, _ in named_leaves(held)]
    with torch.no_grad():
        out = []
        for key, g in zip(keys, grads):
            axes = _leaf_mean_axes(plan, specs[key])
            if axes and ctx.size(axes) > 1:
                g = coll.raw_psum(g.contiguous(), ctx, axes) / ctx.size(axes)
            out.append(g)
        it = iter(out)
        grad_tree = map_tree(lambda _: next(it), params)
        norm = _global_norm(plan, ctx, grad_tree)
        stacked = stack_blocks(params, plan.cfg)
        ps, gs, sliced = _zero1_slices(plan, ctx, stacked,
                                       stack_blocks(grad_tree, plan.cfg))
        del grad_tree, out, grads
        if plan.opt_cfg.kind == "adafactor":
            _, opt_state, om = adafactor_update(
                plan.opt_cfg, gs, opt_state, ps, norm,
                _sharded_mean(plan, ctx, sliced))
        else:
            _, opt_state, om = adamw_update(plan.opt_cfg, gs, opt_state, ps,
                                            norm)
        zs = dict(named_leaves(ps))
        for key, full in named_leaves(stacked):
            if key in sliced:
                got = coll.raw_all_gather(zs[key].contiguous(), ctx, "data")
                full.copy_(got.reshape(full.shape))
        _unstack_into(params, stacked, plan.cfg)
        dp = dp_axes_of(plan.mesh)
        mean = coll.raw_psum(sums, ctx, dp) / ctx.size(dp) if dp else sums
    metrics = {"loss": mean[0], "ce": mean[1], "aux": mean[2],
               "lr": torch.tensor(om["lr"]), "grad_norm": om["grad_norm"]}
    return params, opt_state, metrics


def serve_body(plan: Plan, ctx, params, tokens, cache, cache_index, *enc):
    """One rank's prefill or decode: (the rank's vocabulary block of the
    logits (B_loc, S, V_loc) f32, the cache updated in place)."""
    tp = RankTP(plan, ctx, cache)
    names = list(_enc_specs(plan.cfg, 1, 1))
    idx = int(cache_index)
    with torch.no_grad():
        work = working_params(params, plan, tp)
        dist = _mesh_ctx(plan, ctx)
        kw = dict(cache=cache, dist=dist, tp=tp)
        if plan.kind == "decode":
            b = tokens.shape[0]
            kw["lengths"] = torch.full((b,), idx, dtype=torch.int32,
                                       device=tokens.device)
        else:
            kw["cache_index"] = idx
            kw.update(dict(zip(names, enc)))
        logits, cache = forward(work, tokens, plan.local_cfg, **kw)
    return logits, cache


# ------------------------------------------------------------ bundles
@dataclass
class StepBundle:
    """A step: ``fn(ctx, *rank_inputs)`` is one rank's body; ``in_specs``
    the global inputs (meta tensors, positional, the counterpart of
    ``in_sds``); ``plan.specs`` their spec trees."""
    name: str
    fn: Callable
    in_specs: tuple
    plan: Plan
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: object

    def rank_inputs(self, inputs: tuple, rank: int) -> tuple:
        """Rank ``rank``'s slices of the global ``inputs``."""
        return tuple(self.rank_slice(i, x, rank)
                     for i, x in enumerate(inputs))

    def rank_slice(self, i: int, x, rank: int):
        """Rank ``rank``'s slice of input ``i`` (a serving step's
        self-attention cache leaves with their hidden scratch row, as
        ``make_cache`` builds them)."""
        spec = self.plan.specs[i]
        if not isinstance(x, (dict, list)):
            return _shard_tensor(x, spec, self.mesh, rank)
        out = shard_for_rank(x, spec, self.mesh, rank)
        if self.name != "train" and i == 2:
            out = [{k: (_with_scratch_copy(v) if k in ("k", "v") else v)
                    for k, v in layer.items()} for layer in out]
        return out

    def run(self, pool, inputs: tuple) -> list:
        """The body on every rank of a ``RankPool``; each rank's result."""
        return pool.run(self.fn, self.mesh,
                        [self.rank_inputs(inputs, r)
                         for r in range(self.mesh.size)])

    def rank_specs(self, rank: int = 0) -> tuple:
        """Rank ``rank``'s input slices as meta tensors."""
        return self.rank_inputs(self.in_specs, rank)


def _with_scratch_copy(t):
    """``t`` copied into the first rows of a buffer one row longer (the
    hidden scratch row of dropped writes, ``layers.attention``)."""
    buf = t.new_zeros((t.shape[0] + 1,) + tuple(t.shape[1:]))
    buf[:t.shape[0]].copy_(t)
    return buf[:t.shape[0]]


def _shard_tensor(x, spec, mesh, rank):
    if not spec:
        return x
    return shard_for_rank({"x": x}, {"x": spec}, mesh, rank)["x"]


def _default_opt(cfg: ModelConfig) -> OptConfig:
    return OptConfig(kind="adafactor" if (cfg.moe and cfg.moe.n_experts
                                          >= 256) else "adamw")


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                     opt_cfg: Optional[OptConfig] = None,
                     options: Optional[StepOptions] = None) -> StepBundle:
    opt_cfg = opt_cfg or _default_opt(cfg)
    opts = default_options(cfg, shape, mesh, options)
    p_sds = params_sds(cfg)
    fsdp = needs_fsdp(cfg, mesh, p_sds)
    o_sds = opt_sds(opt_cfg, p_sds, cfg)
    b_sds = batch_specs(cfg, shape)
    p_specs = param_specs(p_sds, cfg, mesh, fsdp_experts=fsdp)
    o_specs = _opt_specs(o_sds, stack_specs(p_specs, cfg), mesh,
                         opts.zero1)
    b_pspecs = batch_pspecs(b_sds, mesh)
    plan = make_plan("train", cfg, shape, mesh, opts, opt_cfg,
                     (p_specs, o_specs, b_pspecs), fsdp)
    return StepBundle("train", functools.partial(train_body, plan),
                      (p_sds, o_sds, b_sds), plan, cfg, shape, mesh)


def build_serve_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                     mode: str = "decode",
                     options: Optional[StepOptions] = None) -> StepBundle:
    """mode='decode': one new token against a seq_len KV cache.
    mode='prefill': process seq_len tokens, filling the cache (the
    encoder inputs, when the stack has them, positional after the cache
    index)."""
    opts = default_options(cfg, shape, mesh, options)
    if mode == "decode":
        opts = dataclasses.replace(opts, seq_shard=False)
    p_sds = params_sds(cfg)
    fsdp = needs_fsdp(cfg, mesh, p_sds)
    b, s = shape.global_batch, shape.seq_len
    el = encoder_len(cfg, shape)
    cache_sds = make_cache(cfg, b, s, src_len=max(el, 1), device="meta")
    p_specs = param_specs(p_sds, cfg, mesh, fsdp_experts=fsdp)
    dp = dp_axes_of(mesh)
    c_specs = cache_specs(cache_sds, cfg, mesh, dp=dp)
    tok = _meta((b, 1 if mode == "decode" else s), torch.int32)
    tok_spec = valid_spec(tok.shape, (dp, None), mesh)
    idx = torch.zeros((), dtype=torch.int32)
    enc = list(_enc_specs(cfg, b, el).values()) if mode == "prefill" else []
    enc_specs = [valid_spec(v.shape, (dp, None, None), mesh) for v in enc]
    specs = (p_specs, tok_spec, c_specs, ()) + tuple(enc_specs)
    plan = make_plan(mode, cfg, shape, mesh, opts, None, specs, fsdp,
                     cache_spec_tree=c_specs)
    return StepBundle(mode, functools.partial(serve_body, plan),
                      (p_sds, tok, cache_sds, idx, *enc), plan, cfg, shape,
                      mesh)


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input of one benchmark cell
    (no storage), the dry-run contract.  For trains: {tokens, labels,
    ...}; for serving: {params, tokens, cache, cache_index, ...}."""
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return batch_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    el = encoder_len(cfg, shape)
    out = {
        "params": params_sds(cfg),
        "tokens": _meta((b, 1 if shape.kind == "decode" else s),
                        torch.int32),
        "cache": make_cache(cfg, b, s, src_len=max(el, 1), device="meta"),
        "cache_index": _meta((), torch.int32),
    }
    if shape.kind == "prefill":
        out.update(_enc_specs(cfg, b, el))
    return out


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
               options: Optional[StepOptions] = None, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, options=options, **kw)
    return build_serve_step(cfg, shape, mesh, mode=shape.kind,
                            options=options, **kw)
