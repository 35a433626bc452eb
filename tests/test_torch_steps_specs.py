"""The step builders' layouts against the reference's specs, over the
production meshes, without a rank or a byte of storage.

For every ``ASSIGNED`` config and each of its ``applicable_shapes``, on
the 16 x 16 and the 2 x 16 x 16 meshes: each rank's shard shape of every
parameter, optimizer-state, batch and cache leaf is the reference's
(``param_specs``, ``_opt_specs``, ``batch_pspecs``, ``cache_specs`` over
``jax.sharding.AbstractMesh``), leaf by named leaf, and so are the bytes
a rank holds.  The reference stacks a slot's layers on a superblock dim:
a port layer's leaf is compared with its slot's leaf without that dim
(parameters, cache), and the port's optimizer state is kept in the
stacked layout (``launch.steps.stack_blocks``) and compared as it is.
``SHAPES``, ``applicable_shapes``, ``default_options``, ``needs_fsdp``,
``model_flops`` and ``input_specs``' shapes and dtypes equal the
reference's too.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jcfgs
from repro.distributed import sharding as jsh
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import active_param_count as jx_active
from repro.models import make_cache as jx_make_cache
from repro.training.optim import OptConfig as JOpt
from repro.training.optim import opt_init as jx_opt_init
from repro_torch import configs as tcfgs
from repro_torch.distributed.sharding import cache_specs, param_specs
from repro_torch.launch import steps
from repro_torch.launch.dryrun import embed_param_count
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import model_flops
from repro_torch.models import active_param_count, make_cache
from repro_torch.tree import named_leaves

torch.set_num_threads(2)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
CACHE_NAMES = {"k": ("self", "k"), "v": ("self", "v"),
               "cross_k": ("cross", "k"), "cross_v": ("cross", "v"),
               "conv": ("mamba", "conv"), "h": ("mamba", "h"),
               "shift": ("rwkv", "shift"), "s": ("rwkv", "s"),
               "shift_c": ("rwkv", "shift_c")}


def _abstract(multi_pod: bool):
    shape, axes = MESHES[multi_pod]
    return AbstractMesh(shape, axes)


def _shard_shape(shape, spec, sizes: dict) -> tuple:
    out = []
    for d, dim in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        n = math.prod(sizes[a] for a in axes)
        assert dim % n == 0
        out.append(dim // n)
    return tuple(out)


def _itemsize(dtype) -> int:
    return np.dtype(dtype).itemsize if not isinstance(dtype, torch.dtype) \
        else torch.empty((), dtype=dtype).element_size()


def _ref_leaves(tree, specs, sizes) -> dict:
    """{"a/b/c": (shard shape, itemsize)} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for (path, leaf), (_, spec) in zip(flat, sflat):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (_shard_shape(leaf.shape, tuple(spec), sizes),
                    _itemsize(leaf.dtype))
    return out


def _port_leaves(tree, specs, sizes) -> dict:
    spec_of = dict(steps._named_specs(specs))
    return {key: (_shard_shape(t.shape, spec_of[key], sizes),
                  t.element_size())
            for key, t in named_leaves(tree)}


def _layer_key(key: str, cfg) -> tuple:
    """A port parameter key -> (reference key, its superblock count)."""
    parts = key.split("/")
    if parts[0] in ("blocks", "enc_blocks"):
        period = len(cfg.block_pattern) if parts[0] == "blocks" else 1
        i = int(parts[1])
        return "/".join([parts[0], f"slot{i % period}"] + parts[2:]), period
    return key, None


def _compare_layers(port: dict, ref: dict, cfg) -> None:
    """Per-layer port leaves against the stacked reference leaves: the
    shape without the superblock dim, and per-rank bytes in total."""
    seen = set()
    total_p = total_r = 0
    for key, (shape, size) in port.items():
        rkey, period = _layer_key(key, cfg)
        rshape, rsize = ref[rkey]
        total_p += math.prod(shape) * size
        if period is None:
            assert shape == rshape, (key, shape, rshape)
        else:
            assert shape == rshape[1:], (key, shape, rshape)
        if rkey not in seen:
            seen.add(rkey)
            total_r += math.prod(rshape) * rsize
        assert size == rsize, key
    assert seen == set(ref), set(ref) ^ seen
    assert total_p == total_r


@functools.lru_cache(maxsize=None)
def _sds(arch: str):
    return steps.params_sds(tcfgs.get_config(arch)), \
        jsteps.params_sds(jcfgs.get_config(arch))


def test_shapes_and_assigned_are_the_reference():
    assert tcfgs.ASSIGNED == jcfgs.ASSIGNED
    assert {k: dataclasses.astuple(v) for k, v in tcfgs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jcfgs.SHAPES.items()}
    for arch in tcfgs.list_configs():
        assert tcfgs.applicable_shapes(tcfgs.get_config(arch)) == \
            jcfgs.applicable_shapes(jcfgs.get_config(arch)), arch


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", tcfgs.ASSIGNED)
def test_rank_shards_equal_the_reference_specs(arch, multi_pod):
    """Parameters, optimizer state, batch and cache of every applicable
    shape: each rank's shard of every named leaf and its bytes."""
    cfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    mesh, jmesh = make_production_mesh(multi_pod=multi_pod), \
        _abstract(multi_pod)
    sizes = dict(mesh.shape)
    p_sds, j_sds = _sds(arch)
    fsdp = steps.needs_fsdp(cfg, mesh, p_sds)
    assert fsdp == jsteps.needs_fsdp(jcfg, jmesh, j_sds)
    p_specs = param_specs(p_sds, cfg, mesh, fsdp_experts=fsdp)
    j_specs = jsh.param_specs(j_sds, jcfg, jmesh, fsdp_experts=fsdp)
    _compare_layers(_port_leaves(p_sds, p_specs, sizes),
                    _ref_leaves(j_sds, j_specs, sizes), cfg)
    # optimizer state: AdamW, and Adafactor for >= 256 experts (Kimi K2)
    kinds = ["adamw"] + (["adafactor"] if cfg.moe and
                         cfg.moe.n_experts >= 256 else [])
    for kind in kinds:
        o_sds = steps.opt_sds(steps.OptConfig(kind=kind), p_sds, cfg)
        o_specs = steps._opt_specs(o_sds, steps.stack_specs(p_specs, cfg),
                                   mesh, True)
        jo = jax.eval_shape(lambda p: jx_opt_init(JOpt(kind=kind), p), j_sds)
        jo_specs = jsteps._opt_specs(jo, j_specs, jmesh, True)
        port = _port_leaves(o_sds, o_specs, sizes)
        ref = _ref_leaves(jo, jo_specs, sizes)
        assert port == ref, kind
    for shape_name in tcfgs.applicable_shapes(cfg):
        shape = tcfgs.SHAPES[shape_name]
        b = steps.batch_specs(cfg, shape)
        jb = jsteps.batch_specs(jcfg, jcfgs.SHAPES[shape_name])
        assert _port_leaves(b, steps.batch_pspecs(b, mesh), sizes) == \
            _ref_leaves(jb, jsteps.batch_pspecs(jb, jmesh), sizes)
        if shape.kind == "train":
            continue
        el = steps.encoder_len(cfg, shape)
        n, s = shape.global_batch, shape.seq_len
        cache = make_cache(cfg, n, s, src_len=max(el, 1), device="meta")
        jcache = jax.eval_shape(lambda: jx_make_cache(jcfg, n, s,
                                                      src_len=max(el, 1)))
        dp = steps.dp_axes_of(mesh)
        port = _port_leaves(cache, cache_specs(cache, cfg, mesh, dp=dp),
                            sizes)
        ref = _ref_leaves(jcache, jsh.cache_specs(jcache, jcfg, jmesh,
                                                  dp=dp), sizes)
        renamed = {}
        for key, val in port.items():
            i, name = key.split("/")
            group, leaf = CACHE_NAMES[name]
            renamed[f"blocks/{i}/{group}/{leaf}"] = val
        _compare_layers(renamed, {
            "blocks/" + k: v for k, v in ref.items()}, cfg)


@pytest.mark.parametrize("arch", tcfgs.ASSIGNED)
def test_options_flops_and_input_specs_equal_the_reference(arch):
    """default_options, model_flops and input_specs of every applicable
    shape on both meshes."""
    cfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    p_sds, j_sds = _sds(arch)
    n_active = active_param_count(p_sds, cfg)
    assert n_active == jx_active(j_sds, jcfg)
    for multi_pod in (False, True):
        mesh, jmesh = make_production_mesh(multi_pod=multi_pod), \
            _abstract(multi_pod)
        for name in tcfgs.applicable_shapes(cfg):
            shape, jshape = tcfgs.SHAPES[name], jcfgs.SHAPES[name]
            got = steps.default_options(cfg, shape, mesh)
            want = jsteps.default_options(jcfg, jshape, jmesh)
            # the reference's donate: the port always updates in place
            want = dataclasses.asdict(want)
            assert want.pop("donate") is True
            assert dataclasses.asdict(got) == want
            assert model_flops(cfg, shape, n_active,
                               embed_param_count(cfg)) == \
                jroof.model_flops(jcfg, jshape, n_active,
                                  embed_param_count(jcfg))
    for name in tcfgs.applicable_shapes(cfg):
        got = steps.input_specs(arch, name)
        want = jsteps.input_specs(arch, name)
        assert set(got) == set(want)
        for key in set(got) - {"params", "cache"}:
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            assert str(got[key].dtype).split(".")[-1] == \
                str(want[key].dtype), key
        for key in ("params", "cache"):
            if key in got:
                assert sum(t.numel() * t.element_size()
                           for _, t in named_leaves(got[key])) == \
                    sum(x.size * x.dtype.itemsize
                        for x in jax.tree.leaves(want[key])), key
