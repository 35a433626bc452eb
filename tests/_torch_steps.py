"""Shared by the train-step bundle tests (``test_torch_steps_train*``):
the reference's single-device step and one case run on a rank pool.  See
``test_torch_steps_train.py`` for what is compared and why."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.models import init_params as jx_init_params
from repro.models import loss_fn as jx_loss_fn
from repro.training.optim import OptConfig as JOpt
from repro.training.optim import opt_init as jx_opt_init
from repro.training.optim import opt_update as jx_opt_update
from repro_torch import bridge
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.distributed.sharding import _at, _entry_axes, _tree_map
from repro_torch.launch.mesh import axes_index, make_host_mesh, rank_coords
from repro_torch.launch.steps import (StepOptions, build_train_step,
                                      stack_blocks)
from repro_torch.training.optim import OptConfig, opt_init
from repro_torch.tree import named_leaves

torch.set_num_threads(2)
TOL = 1e-5
B = 4
LR = dict(lr=1e-3, warmup_steps=0, eps=1e-4)


def gather_from_ranks(trees: list, specs, mesh):
    """The whole tree from every rank's slices (``shard_for_rank``'s
    inverse): ``trees[r]`` is rank r's."""
    def whole(path, first):
        spec = _at(specs, path)
        shape = list(first.shape)
        for d, entry in enumerate(spec):
            shape[d] *= math.prod(mesh.shape[a] for a in _entry_axes(entry))
        out = first.new_empty(shape)
        for r, tree in enumerate(trees):
            part = _at(tree, path)
            coords = rank_coords(mesh, r)
            index = []
            for d, entry in enumerate(spec):
                axes = _entry_axes(entry)
                i = axes_index(mesh, coords, axes) if axes else 0
                index.append(slice(i * part.shape[d],
                                   (i + 1) * part.shape[d]))
            out[tuple(index)] = part
        return out
    return _tree_map(whole, trees[0])


def _reference(arch, s, mb, n_dp, toks, labels, kind):
    """(loss, grad norm, new params as numpy) of the reference."""
    jcfg = jx_reduced(jx_get_config(arch), vocab_size=512)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    per_shard = jcfg.moe is not None
    rows = B // n_dp // mb if per_shard else B
    tg, lg = (a.reshape(B // rows, rows, s) for a in (toks, labels))

    def loss(p):
        parts = jax.vmap(lambda t, lab: jx_loss_fn(
            p, {"tokens": t, "labels": lab}, jcfg)[0])(tg, lg)
        return parts.mean()

    value, grads = jax.jit(jax.value_and_grad(loss))(jparams)
    norm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                        for g in jax.tree.leaves(grads)))
    opt = JOpt(kind=kind, **LR)
    new, _, _ = jx_opt_update(opt, grads, jx_opt_init(opt, jparams), jparams)
    return float(value), float(norm), jparams, jax.tree.map(np.asarray, new)


def case_id(c) -> str:
    return f"{c[0]}-s{c[1]}-mb{c[2]}-{'x'.join(map(str, c[3]))}" + \
        "".join(f"-{x}" for x in c[4:])


def run_case(pool, case):
    """One (arch, S, microbatches, (pod, data, model)[, optimizer]) case:
    the ranks' loss, gradient norm and new parameters against the
    reference's (AdamW unless the case names Adafactor).  Returns the
    bundle."""
    arch, s, mb, (pod, data, model) = case[:4]
    kind = case[4] if len(case) > 4 else "adamw"
    cfg = reduced(get_config(arch), vocab_size=512)
    mesh = make_host_mesh(data=data, model=model, pod=pod, device="cpu")
    n_dp = (pod or 1) * data
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (B, s)).astype(np.int32)
    labels = rng.integers(0, 512, (B, s)).astype(np.int32)
    loss, norm, jparams, want = _reference(arch, s, mb, n_dp, toks, labels,
                                           kind)
    opt_cfg = OptConfig(kind=kind, **LR)
    bundle = build_train_step(cfg, ShapeSpec("t", s, B, "train"), mesh,
                              opt_cfg=opt_cfg,
                              options=StepOptions(microbatches=mb))
    if cfg.moe is not None:
        assert s % model, "the reference's function is per shard: rep EP"
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    opt = opt_init(opt_cfg, stack_blocks(params, cfg))
    batch = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    outs = bundle.run(pool, (params, opt, batch))
    for o in outs:
        assert abs(float(o[2]["loss"]) - loss) < TOL, (o[2]["loss"], loss)
        assert abs(float(o[2]["grad_norm"]) - norm) < TOL * max(1.0, norm)
    got = gather_from_ranks([o[0] for o in outs], bundle.plan.specs[0],
                            mesh)
    want = dict(named_leaves(bridge.params_from_jax(want, cfg,
                                                    device="cpu")))
    for key, leaf in named_leaves(got):
        err = float((leaf - want[key]).abs().max())
        assert err < TOL, (key, err)
    return bundle
