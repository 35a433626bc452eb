"""Sharding rules: the split of every parameter and cache leaf over the
tensor-parallel axis, with the divisibility fallback to replication.

Counterpart of ``repro/distributed/sharding.py`` (``valid_spec``,
``_param_spec``, ``_head_aligned``, ``param_specs``, ``cache_specs``,
``paged_cache_specs``).  A spec is a tuple with one entry per dimension of
its leaf, the mesh axis (or tuple of axes) that dimension splits over or
None, as the reference's ``PartitionSpec``; a mesh is anything with a
``shape`` dict of axis sizes (``launch.mesh.Mesh``).  The port keeps a
layer's parameters unstacked (``params["blocks"][i]``), so its block
specs lack the reference's leading superblock dimension; every other
entry is the reference's rule for the same leaf.

``shardings_for`` gives a tree's valid specs over a mesh (the reference's
``NamedSharding`` tree) and ``shard_for_rank`` a rank's slices by them:
along each split dimension the rank's contiguous block, by its index over
that entry's axes; ``shard_params`` is the tensor-parallel serving
backend's use of it.

``make_shd`` is the reference's activation hook read per name.  The port
has no GSPMD: the step builders (``launch.steps``) run one body a rank,
and the hook says, for each named activation, the spec of what the rank
holds; the step body exchanges what the spec asks for with the port's
collectives.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axes_index, rank_coords


# ------------------------------------------------------------------ helpers
def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def valid_spec(shape, spec: tuple, mesh) -> tuple:
    """Drop spec axes that don't divide the dim (replicate instead)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(axis if axis and dim % _axis_size(mesh, axis) == 0 else None
                 for dim, axis in zip(shape, entries))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def shardings_for(tree, spec_tree, mesh):
    """The tree of valid specs (``valid_spec`` of each leaf's candidate
    over ``mesh``): the port's counterpart of the reference's
    ``NamedSharding`` tree."""
    return _tree_map(
        lambda path, leaf: valid_spec(leaf.shape, _at(spec_tree, path), mesh),
        tree)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_for_rank(tree, specs, mesh, rank: int):
    """Rank ``rank``'s slice of every leaf of ``tree`` by its spec: along
    each dimension split over axes, the block at the rank's index over
    them (a copy in a storage of its own); a replicated leaf is the given
    tensor itself."""
    coords = rank_coords(mesh, rank)

    def take(path, leaf):
        out = leaf
        for dim, entry in enumerate(_at(specs, path)):
            axes = _entry_axes(entry)
            if axes:
                n = math.prod(mesh.shape[a] for a in axes)
                size = out.shape[dim] // n
                out = out.narrow(dim, axes_index(mesh, coords, axes) * size,
                                 size)
        if out is leaf:
            return leaf
        # a storage of its own: a view would carry (and serialize) the whole
        return out.clone(memory_format=torch.contiguous_format)
    return _tree_map(take, tree)


def split_dim(spec: tuple, axis: str = "model") -> Optional[int]:
    """The dimension ``spec`` splits over ``axis`` (None: replicated)."""
    for d, a in enumerate(spec):
        if a == axis or (isinstance(a, (tuple, list)) and axis in a):
            return d
    return None


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


# ------------------------------------------------------------------ params
def _param_spec(path_keys, leaf_shape, cfg: ModelConfig, tp: str,
                fsdp_experts: bool = False) -> tuple:
    """Candidate spec for one param leaf (before divisibility fallback)."""
    name = path_keys[-1]

    def mk(*dims):
        return tuple(dims)

    # --- embeddings / head
    if name == "embed":
        return (tp, None)
    if name == "lm_head":
        return (None, tp)
    # --- norms and scalars
    if name in ("scale", "bias", "xgate", "w0", "u", "ln_scale", "ln_bias",
                "conv_b", "dt_b", "D"):
        return (None,) * len(leaf_shape)
    # --- MoE
    if "moe" in path_keys:
        if name == "router":
            return mk(None, None)
        if name in ("w_in", "w_gate"):         # (E, D, F)
            return mk(tp, None, "data" if fsdp_experts else None)
        if name == "w_out":                    # (E, F, D)
            return mk(tp, "data" if fsdp_experts else None, None)
        if name in ("shared_in", "shared_gate"):
            return mk(None, tp)
        if name == "shared_out":
            return mk(tp, None)
    # --- rwkv time/channel mix
    if name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
        return mk(None)
    if name in ("wA", "wB"):
        return mk(None, None)
    # --- mamba
    if name in ("in_proj", "conv_w", "dt_w"):
        return mk(None, tp)
    if name in ("x_proj", "A_log", "out_proj"):
        return mk(tp, None)
    # --- rwkv channel-mix lives under "mlp": (D,F)/(F,D) like a dense MLP
    if "mlp" in path_keys and name == "wk":
        return mk(None, tp)
    if "mlp" in path_keys and name == "wv":
        return mk(tp, None)
    # --- attention & generic projections (head-aligned check by caller)
    if name in ("wq", "wk", "wv", "wg", "wr"):
        return mk(None, tp)
    if name in ("bq", "bk", "bv"):
        return mk(tp)
    if name == "wo":
        return mk(tp, None)
    # --- dense mlp
    if name in ("w_in", "w_gate"):
        return mk(None, tp)
    if name == "w_out":
        return mk(tp, None)
    return (None,) * len(leaf_shape)


def _head_aligned(name, path_keys, cfg: ModelConfig, mesh, tp) -> bool:
    """Attention projections: only shard the flattened head dim if the
    shard boundary falls between heads (H % tp == 0)."""
    if "moe" in path_keys or "mlp" in path_keys:
        return True
    if name in ("wq", "wo", "wg", "wr", "bq"):
        return cfg.n_heads % mesh.shape[tp] == 0
    if name in ("wk", "wv", "bk", "bv"):
        return cfg.n_kv_heads % mesh.shape[tp] == 0
    return True


def param_specs(params, cfg: ModelConfig, mesh, tp: str = "model",
                fsdp_experts: bool = False):
    """Spec tree (tuples) for a param tree, the reference's rules."""
    def spec_of(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        spec = _param_spec(keys, leaf.shape, cfg, tp, fsdp_experts)
        if not _head_aligned(keys[-1], keys, cfg, mesh, tp):
            spec = (None,) * leaf.dim()
        return valid_spec(leaf.shape, spec, mesh)
    return _tree_map(spec_of, params)


_EXPERTS = ("w_in", "w_gate", "w_out")


def expert_param_specs(params, cfg: ModelConfig, mesh,
                       fsdp_experts: bool = False):
    """An expert-parallel rank's layout: ``param_specs`` for the MoE
    experts (``w_in``/``w_gate``/``w_out`` over "model", and over "data"
    along d_ff with ``fsdp_experts``), every other leaf replicated (the
    port's ``forward(dist=...)`` runs every other layer whole on each
    rank)."""
    specs = param_specs(params, cfg, mesh, "model", fsdp_experts)

    def spec_of(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        if "moe" in keys and keys[-1] in _EXPERTS:
            return _at(specs, path)
        return (None,) * leaf.dim()
    return _tree_map(spec_of, params)


class _ModelAxis:
    """A (data=1, model=tp) mesh's shape alone: what the rules read."""

    def __init__(self, tp: int):
        self.shape = {"data": 1, "model": tp}


def serving_param_specs(params, cfg: ModelConfig, tp: int):
    """``param_specs`` over a (data=1, model=tp) mesh with the embedding
    and the LM head replicated, as the reference's sharded backend places
    them (every rank computes the full logits row)."""
    specs = param_specs(params, cfg, _ModelAxis(tp), tp="model")
    specs["embed"] = (None, None)
    if "lm_head" in specs:
        specs["lm_head"] = (None, None)
    return specs


def shard_params(params, cfg: ModelConfig, tp: int, rank: int):
    """Rank ``rank``'s tensors of a tp-way split: wq/wk/wv (and their
    biases) by head columns, wo by head rows, the MLP's d_ff, each a
    contiguous copy of its slice in a storage of its own; replicated
    leaves (the embedding, the head, the norms) are the given tensors
    themselves."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a tp={tp} group")
    return shard_for_rank(params, serving_param_specs(params, cfg, tp),
                          _ModelAxis(tp), rank)


# ------------------------------------------------------------------ cache
KV_REPLICATE_BUDGET = 4e9   # bytes/device a replicated-over-tp cache may use
# the leaves the reference names "k" and "v": its self cache's and its
# cross cache's ("cross" -> "k"/"v"), the port's cross_k / cross_v
_KV = ("k", "v", "cross_k", "cross_v")


def cache_specs(cache, cfg: ModelConfig, mesh, dp=("data",),
                tp: str = "model"):
    """The per-layer contiguous cache: batch over dp; heads over tp when
    divisible.  When heads don't divide: REPLICATE over tp if the
    per-device cache fits the budget, otherwise shard the sequence dim
    over tp (the reference's rule; the sharded backend only serves
    divisible head counts).  A cross layer's ``cross_k``/``cross_v``
    follow the same rule and count in the budget, as the reference's
    ``cross`` cache does."""
    dpt = tuple(dp)
    n_dp = math.prod(mesh.shape[a] for a in dpt)
    kv_total = sum(t.numel() * t.element_size() for layer in cache
                   for name, t in layer.items() if name in _KV)
    kv_fits = (kv_total / max(n_dp, 1)) <= KV_REPLICATE_BUDGET

    def spec_for(path, leaf):
        name, shape = path[-1], leaf.shape
        if name in _KV:                        # (B, T, HKV, hd)
            if cfg.n_kv_heads % mesh.shape[tp] == 0:
                s = (dpt, None, tp, None)
            elif kv_fits:
                s = (dpt, None, None, None)
            else:
                s = (dpt, tp, None, None)
            return valid_spec(shape, s, mesh)
        if name == "h":                        # mamba (B, di, ds)
            return valid_spec(shape, (dpt, tp, None), mesh)
        if name == "conv":                     # (B, K-1, di)
            return valid_spec(shape, (dpt, None, tp), mesh)
        if name == "s":                        # rwkv (B, H, hd, hd)
            return valid_spec(shape, (dpt, None, None, None), mesh)
        if name in ("shift", "shift_c"):       # (B, D)
            return valid_spec(shape, (dpt, None), mesh)
        return (None,) * len(shape)
    return _tree_map(spec_for, cache)


def paged_cache_specs(pages, cfg: ModelConfig, mesh, tp: str = "model"):
    """The per-layer paged pool: pages (P, bs, HKV, hd) split on their
    KV-head axis over ``tp`` like the contiguous cache, and an int8 pool's
    ``k_scale``/``v_scale`` (P, bs, HKV) on the same head axis as their
    payload.  The pool is global (rows reach it through block tables), so
    no axis carries ``data``."""
    def spec_for(path, leaf):
        name = path[-1]
        if name in ("k_pages", "v_pages"):
            return valid_spec(leaf.shape, (None, None, tp, None), mesh)
        if name in ("k_scale", "v_scale"):
            return valid_spec(leaf.shape, (None, None, tp), mesh)
        return (None,) * leaf.dim()
    return _tree_map(spec_for, pages)


# ------------------------------------------------------------------ activations
def make_shd(mesh, dp=("data",), tp: str = "model", seq_shard: bool = False):
    """The reference's activation hook: ``shd(name, shape)`` is the spec
    (valid over ``mesh``) of what a rank holds of the activation ``name``
    of ``shape``.

    * ``act`` / ``resid``: the residual stream, the batch over ``dp``; with
      ``seq_shard`` a 3-d stream is also split along S over ``tp`` (the
      step body all-gathers S where a layer needs it whole and keeps the
      rank's block between layers);
    * ``logits``: the rank's block of the vocabulary (``(dp, None, tp)``);
    * ``q_decode``: a decode step's queries, the batch over dp, every head;
    * ``q_heads`` / ``kv_heads``: head-parallel attention (heads over
      ``tp``, dropped when they do not divide);
    * ``wkv``: the recurrence's batch over-shard, over every axis of
      ``dp`` + ``tp`` whose running product divides the batch.
    """
    dpt = tuple(dp)

    def shd(name: str, shape) -> tuple:
        nd = len(shape)
        if name in ("act", "resid"):
            if seq_shard and nd == 3:
                spec = (dpt, tp) + (None,) * (nd - 2)
            else:
                spec = (dpt,) + (None,) * (nd - 1)
        elif name == "logits":
            spec = (dpt, None, tp)
        elif name == "q_decode":
            spec = (dpt,) + (None,) * (nd - 1)
        elif name in ("q_heads", "kv_heads"):
            spec = (dpt, None, tp, None)
        elif name == "wkv":
            axes, prod = [], 1
            for a in dpt + (tp,):
                if shape[0] % (prod * mesh.shape[a]) == 0:
                    axes.append(a)
                    prod *= mesh.shape[a]
            spec = (tuple(axes),) + (None,) * (nd - 1)
        else:
            spec = (None,) * nd
        return valid_spec(shape, spec, mesh)

    return shd
