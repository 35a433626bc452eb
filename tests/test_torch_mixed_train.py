"""Training a stack of RWKV-6 beside attention, the port against the JAX
package, in f32 on the CPU.

* ``loss_fn`` on reduced ``rwkv6-3b`` with ``block_pattern`` ``("rwkv6",
  "attn")`` and ``("attn", "rwkv6")`` (4 layers) against
  ``jax.value_and_grad`` of the reference's, from the same weights and
  batch: the loss within 1e-5 relative, every gradient leaf within 1e-5
  of its largest entry; ``wkv6`` trains through its functional entry and
  attention through the flash backward rule.  Each remat policy, applied
  a layer at a time, gives the same loss and gradients.
* The step builders' layouts of the full-width mixed stack over the
  abstract 16 x 16 mesh: each rank's shard of every parameter, AdamW
  state, batch and cache leaf against the reference's specs, as
  ``test_torch_steps_specs.py`` holds the assigned configs; the tensor
  parallel plan splits the attention heads and the RWKV-6 heads together
  or neither (40 heads over 16: neither).
* One train step of the reduced mixed stack on two CPU ranks (data 1,
  model 2) against the reference's single-device ``value_and_grad`` and
  ``opt_update``, as ``test_torch_steps_train.py`` does (``_torch_steps``).
"""
import multiprocessing

import jax
import numpy as np
import pytest
import torch

import _torch_steps as st
from repro import configs as jcfgs
from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.data.pipeline import DataConfig as JxDataConfig
from repro.data.pipeline import make_batch as jx_make_batch
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import init_params as jx_init_params
from repro.models import loss_fn as jx_loss_fn
from repro.models import make_cache as jx_make_cache
from repro.training.optim import OptConfig as JOpt
from repro.training.optim import opt_init as jx_opt_init
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.ranks import RankPool
from repro_torch.distributed.sharding import cache_specs, param_specs
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import REMAT_POLICIES, loss_fn, make_cache
from repro_torch.tree import named_leaves
from test_torch_steps_specs import (CACHE_NAMES, _abstract, _compare_layers,
                                    _port_leaves, _ref_leaves)

torch.set_num_threads(2)
ARCH = "rwkv6-3b"
PATTERNS = (("rwkv6", "attn"), ("attn", "rwkv6"))
IDS = ["rwkv6_attn", "attn_rwkv6"]
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5


def _mixed(get, pattern):
    """The full-width config with ``pattern``; reduced() then keeps two
    superblocks (4 layers)."""
    return lambda name: get(name).replace(block_pattern=pattern)


def _grads(params, batch, cfg, **kw):
    leaves = dict(named_leaves(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(params, batch, cfg, **kw)
    loss.backward()
    return loss.item(), {k: leaf.grad.clone() for k, leaf in leaves.items()}


def _within(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        err = float((got[key] - w).abs().max())
        assert err <= GRAD_TOL * scale, (key, err, scale)


@pytest.mark.parametrize("pattern", PATTERNS, ids=IDS)
def test_loss_and_grads_match_the_reference(pattern):
    jcfg = jx_reduced(_mixed(jx_get_config, pattern)(ARCH))
    cfg = reduced(_mixed(get_config, pattern)(ARCH))
    assert cfg.n_layers == jcfg.n_layers == 4
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    batch = jx_make_batch(JxDataConfig(seed=0, batch=2, seq_len=20,
                                       vocab_size=jcfg.vocab_size), 3, jcfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jx_loss_fn(p, batch, jcfg, remat=False),
        has_aux=True)(jparams)
    want = dict(named_leaves(bridge.params_from_jax(
        jax.tree.map(np.asarray, jgrads), cfg, device="cpu")))
    loss, grads = _grads(params, batch, cfg, remat=False)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _within(grads, want)
    for policy in REMAT_POLICIES:
        loss2, grads2 = _grads(params, batch, cfg, remat=True,
                               remat_policy=policy)
        assert abs(loss2 - loss) <= LOSS_RTOL * abs(loss), policy
        _within(grads2, grads)


def test_rank_shards_equal_the_reference_specs():
    """Full-width ("rwkv6", "attn") over the abstract 16 x 16 mesh:
    parameters, AdamW state, the batch and cache of every applicable
    shape, leaf by named leaf; the plan splits neither kind's heads."""
    pattern = PATTERNS[0]
    cfg = _mixed(tcfgs.get_config, pattern)(ARCH)
    jcfg = _mixed(jcfgs.get_config, pattern)(ARCH)
    mesh, jmesh = make_production_mesh(), _abstract(False)
    sizes = dict(mesh.shape)
    p_sds, j_sds = steps.params_sds(cfg), jsteps.params_sds(jcfg)
    fsdp = steps.needs_fsdp(cfg, mesh, p_sds)
    assert fsdp == jsteps.needs_fsdp(jcfg, jmesh, j_sds)
    p_specs = param_specs(p_sds, cfg, mesh, fsdp_experts=fsdp)
    j_specs = jsh.param_specs(j_sds, jcfg, jmesh, fsdp_experts=fsdp)
    _compare_layers(_port_leaves(p_sds, p_specs, sizes),
                    _ref_leaves(j_sds, j_specs, sizes), cfg)
    o_sds = steps.opt_sds(steps.OptConfig(kind="adamw"), p_sds, cfg)
    o_specs = steps._opt_specs(o_sds, steps.stack_specs(p_specs, cfg), mesh,
                               True)
    jo = jax.eval_shape(lambda p: jx_opt_init(JOpt(kind="adamw"), p), j_sds)
    assert _port_leaves(o_sds, o_specs, sizes) == \
        _ref_leaves(jo, jsteps._opt_specs(jo, j_specs, jmesh, True), sizes)
    names = tcfgs.applicable_shapes(cfg)
    assert names == jcfgs.applicable_shapes(jcfg)
    for name in names:
        shape = tcfgs.SHAPES[name]
        b = steps.batch_specs(cfg, shape)
        jb = jsteps.batch_specs(jcfg, jcfgs.SHAPES[name])
        assert _port_leaves(b, steps.batch_pspecs(b, mesh), sizes) == \
            _ref_leaves(jb, jsteps.batch_pspecs(jb, jmesh), sizes)
        if shape.kind == "train":
            # 40 heads do not split over 16: both kinds run whole
            plan = steps.build_train_step(cfg, shape, mesh).plan
            assert not plan.partial["attn"] and not plan.partial["rwkv6"]
            assert plan.local_cfg.n_heads == cfg.n_heads
            continue
        n, s = shape.global_batch, shape.seq_len
        cache = make_cache(cfg, n, s, device="meta")
        jcache = jax.eval_shape(lambda: jx_make_cache(jcfg, n, s))
        dp = steps.dp_axes_of(mesh)
        port = _port_leaves(cache, cache_specs(cache, cfg, mesh, dp=dp),
                            sizes)
        ref = _ref_leaves(jcache, jsh.cache_specs(jcache, jcfg, jmesh,
                                                  dp=dp), sizes)
        renamed = {}
        for key, val in port.items():
            i, leaf_name = key.split("/")
            group, leaf = CACHE_NAMES[leaf_name]
            renamed[f"blocks/{i}/{group}/{leaf}"] = val
        _compare_layers(renamed, {"blocks/" + k: v for k, v in ref.items()},
                        cfg)


def test_dry_run_traces_a_mixed_decode_cell():
    """Full-width ("rwkv6", "attn") at ``decode_32k`` on 16 x 16, rank 0
    on meta tensors: the step runs the recurrence and the norm windows of
    both kinds (the attention reads its T-split cache in torch ops) and
    fits the card."""
    cfg = _mixed(tcfgs.get_config, PATTERNS[0])(ARCH)
    mesh = make_production_mesh()
    bundle = steps.build_step(cfg, tcfgs.SHAPES["decode_32k"], mesh)
    tr = dryrun.trace_rank(bundle)
    ops = set(tr["recorder"].ops)
    assert {f"repro_torch.{op}.default" for op in (
        "wkv6_fn", "rmsnorm_matmul", "residual_rmsnorm")} <= ops, ops
    assert tr["memory"]["argument_bytes"] > 0
    assert dryrun.fits(tr["memory"])


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, "cpu") as p:
        yield p


@pytest.mark.parametrize("pattern", PATTERNS, ids=IDS)
def test_train_step_on_two_ranks_matches_the_reference(pool, pattern,
                                                       monkeypatch):
    """(data 1, model 2): the attention and RWKV-6 heads, both d_ff and
    the vocabulary split over the model axis."""
    monkeypatch.setattr(st, "jx_get_config", _mixed(jx_get_config, pattern))
    monkeypatch.setattr(st, "get_config", _mixed(get_config, pattern))
    bundle = st.run_case(pool, (ARCH, 8, 1, (0, 1, 2)))
    assert bundle.plan.partial["attn"] and bundle.plan.partial["rwkv6"]


def test_zz_the_pool_closes(pool):
    """Last in the module: the ranks end with the pool."""
    pool.close()
    assert not multiprocessing.active_children()
