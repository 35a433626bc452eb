"""Expert-parallel MoE over gloo rank processes on the CPU, against the
reference's ``moe_ep_fwd`` and ``forward(dist=)`` on the same mesh.

Reduced Moonlight with 8 experts.  The reference runs in a subprocess with
4 forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count
=4``, under ``jax.set_mesh``) and prints its outputs, aux losses and
``jax.grad`` results as JSON; the port runs each case on one pool of 4
rank processes shared by the module.  Inputs and weights are made from a
seed with numpy on both sides (``_INPUTS``).

A rank's gradients follow ``distributed.collectives``' convention: each
is the gradient of the sum of the data-parallel ranks' losses, whose mean
is the global loss.  So the global gradient of a leaf replicated over the
data axis is the mean of the ranks', of a rank's block of x the block's
gradient over the number of data ranks, and of an fsdp shard the shard's
own; over the model axis every rank holds the same gradient of a
replicated leaf and an expert's gradient is its owner's.

Tolerances (f32): outputs within 2e-4 (the reference test's own bound),
the aux within 1e-6, every gradient within 1e-5 x max(1, max |reference|)
of its leaf.
"""
import dataclasses
import multiprocessing

import jax
import numpy as np
import pytest
import torch

import _torch_multirank as mr
from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.models import init_params as jx_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.ranks import RankPool
from repro_torch.distributed.sharding import (expert_param_specs,
                                              shard_for_rank)
from repro_torch.launch.mesh import make_host_mesh, rank_coords
from repro_torch.layers.moe import (MeshContext, capacity, dispatch_slots,
                                    effective_dp_axes, route)

torch.set_num_threads(2)
ARCH = "moonshot-v1-16b-a3b"
OUT_TOL, AUX_TOL, GRAD_TOL = 2e-4, 1e-6, 1e-5

# (name, data, model, mode, fsdp, B, S, capacity factor, skewed routing)
CASES = [
    ("seq_2x2", 2, 2, "seq", None, 4, 8, 8.0, False),
    ("rep_2x2", 2, 2, "rep", None, 4, 8, 8.0, False),
    ("auto_2x2", 2, 2, "auto", None, 4, 8, 8.0, False),
    ("seq_1x4", 1, 4, "seq", None, 4, 8, 8.0, False),
    ("rep_1x4", 1, 4, "rep", None, 4, 8, 8.0, False),
    # S 6 does not divide by ep 4: auto picks rep
    ("auto_1x4_s6", 1, 4, "auto", None, 4, 6, 8.0, False),
    ("seq_fsdp_2x2", 2, 2, "seq", "data", 4, 8, 8.0, False),
    ("rep_fsdp_2x2", 2, 2, "rep", "data", 4, 8, 8.0, False),
    # batch 3 does not divide by data 2: replicated over data
    ("rep_b3_2x2", 2, 2, "rep", None, 3, 8, 8.0, False),
    # Moonlight's own capacity factor, routing skewed towards two experts:
    # tokens drop
    ("drop_seq_1x4", 1, 4, "seq", None, 4, 32, 1.25, True),
    ("drop_rep_2x2", 2, 2, "rep", None, 4, 16, 1.25, True),
]

_INPUTS = """
import numpy as np
E, K, D, F = 8, 2, 64, 64
def moe_inputs(seed, b, s, skew):
    rng = np.random.default_rng(seed)
    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    p = {"router": w(D, E, scale=0.006), "w_in": w(E, D, F),
         "w_gate": w(E, D, F), "w_out": w(E, F, D),
         "shared_in": w(D, F), "shared_gate": w(D, F), "shared_out": w(F, D)}
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    wy = rng.standard_normal((b, s, D)).astype(np.float32)
    if skew:
        x = x + 1.0
        p["router"][:, :2] += 0.05
    return p, x, wy
"""
exec(_INPUTS)

_JAX = _INPUTS + """
import dataclasses, json, jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.layers.moe import MeshContext, moe_ep_fwd
from repro.launch.mesh import make_host_mesh
from repro.models import forward, init_params, loss_fn
CASES = %r
base = reduced(get_config("moonshot-v1-16b-a3b"))
res = {}
for i, (name, data, model, mode, fsdp, b, s, cf, skew) in enumerate(CASES):
    cfg = base.replace(moe=dataclasses.replace(base.moe, n_experts=E,
                                               capacity_factor=cf))
    p, x, wy = moe_inputs(i, b, s, skew)
    p = {k: jnp.asarray(v) for k, v in p.items()}
    mesh = make_host_mesh(data=data, model=model)
    dist = MeshContext(mesh=mesh, dp_axes=("data",), tp_axis="model",
                       fsdp_axis=fsdp)
    def f(p, x_):
        y, aux = moe_ep_fwd(p, x_, cfg, dist, mode=mode)
        return jnp.sum(y * wy) + aux, (y, aux)
    with jax.set_mesh(mesh):
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    res[name] = {"y": np.asarray(y).tolist(), "aux": float(aux),
                 "grads": {"x": np.asarray(gx).tolist(),
                           **{k: np.asarray(v).tolist()
                              for k, v in gp.items()}}}

# model level: reduced Moonlight (4 experts, capacity factor 4), mesh (2, 2)
cfg = base
params = init_params(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(11)
toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 8)), jnp.int32)
labels = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 8)), jnp.int32)
mesh = make_host_mesh(data=2, model=2)
dist = MeshContext(mesh=mesh, dp_axes=("data",), tp_axis="model")
# (outside jax.set_mesh: under it the stack's scan refuses the sharded
# carry)
logits, aux_ep, _ = jax.jit(lambda p, t: forward(p, t, cfg, dist=dist))(
    params, toks)
batch = {"tokens": toks, "labels": labels}
def local_loss(p):
    return loss_fn(p, batch, cfg, aux_weight=0.0)
(loss0, (ce, aux_local)), g = jax.value_and_grad(
    local_loss, has_aux=True)(params)
g = jax.tree_util.tree_map_with_path(
    lambda path, a: np.asarray(a), g)
np.savez(%r, **{jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(g)[0]})
res["model"] = {"logits": np.asarray(logits).tolist(),
                "aux_ep": float(aux_ep), "aux_local": float(aux_local),
                "ce": float(ce), "loss0": float(loss0),
                "tokens": np.asarray(toks).tolist(),
                "labels": np.asarray(labels).tolist()}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def grads_file(tmp_path_factory):
    return str(tmp_path_factory.mktemp("moe_ep") / "model_grads.npz")


@pytest.fixture(scope="module")
def ref(grads_file):
    sub = mr.Reference(_JAX % (CASES, grads_file), devices=4)
    yield sub
    sub.close()


@pytest.fixture(scope="module")
def pool(ref):
    with RankPool(4, device="cpu") as p:
        yield p


def _cfg(cf: float):
    base = reduced(get_config(ARCH))
    return base.replace(moe=dataclasses.replace(base.moe, n_experts=E,
                                                capacity_factor=cf))


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol, (what, err, tol)
    return err


def _case_inputs(i, case):
    name, data, model, mode, fsdp, b, s, cf, skew = case
    cfg = _cfg(cf)
    p, x, wy = moe_inputs(i, b, s, skew)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    dist = MeshContext(mesh, ("data",), "model", fsdp)
    eff = effective_dp_axes(dist, b)
    dist = dist._replace(dp_axes=eff)
    specs = expert_param_specs({"moe": p}, cfg, mesh,
                               fsdp_experts=bool(fsdp))
    n_dp = data if eff else 1
    per_rank = []
    for r in range(mesh.size):
        i_dp = rank_coords(mesh, r)["data"] if eff else 0
        rows = slice(i_dp * b // n_dp, (i_dp + 1) * b // n_dp)
        shard = shard_for_rank({"moe": p}, specs, mesh, r)["moe"]
        per_rank.append((shard, torch.from_numpy(x[rows]).clone(),
                         torch.from_numpy(wy[rows]).clone(), cfg, dist,
                         mode, float(n_dp)))
    return cfg, mesh, dist, n_dp, per_rank


def _assemble(outs, mesh, n_dp, fsdp):
    """The global output and gradients from the ranks' (see the module
    docstring)."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    by = {tuple(rank_coords(mesh, r).values()): o for r, o in
          enumerate(outs)}
    rows = [by[(i, 0)] for i in range(data)]
    if n_dp == 1:          # x replicated over data: a leaf like the others
        y = rows[0][0]
        gx = sum(o[2]["x"] for o in rows) / data
    else:
        y = torch.cat([o[0] for o in rows])
        gx = torch.cat([o[2]["x"] / n_dp for o in rows])
    grads = {"x": gx}
    for k in outs[0][2]:
        if k == "x":
            continue
        if k in ("w_in", "w_gate", "w_out"):
            f_dim = 2 if k != "w_out" else 1
            blocks = []
            for j in range(model):
                if fsdp:
                    blocks.append(torch.cat([by[(i, j)][2][k]
                                             for i in range(data)], f_dim))
                else:
                    blocks.append(sum(by[(i, j)][2][k] for i in range(data))
                                  / data)
            grads[k] = torch.cat(blocks, 0)
        else:
            grads[k] = sum(by[(i, 0)][2][k] for i in range(data)) / data
    # every rank of a model group holds the same output and replicated
    # gradients
    for (i, j), o in by.items():
        torch.testing.assert_close(o[0], by[(i, 0)][0], rtol=0, atol=1e-6)
        for k in ("router", "shared_in", "x"):
            torch.testing.assert_close(o[2][k], by[(i, 0)][2][k], rtol=0,
                                       atol=1e-6)
    return y, grads


def _drops(x, p, cfg, mesh, mode, n_dp):
    """Assignments dropped over the shards (each shard's own capacity)."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    xt = torch.from_numpy(x)
    total = 0
    for xb in xt.chunk(n_dp):
        shards = xb.chunk(model, dim=1) if mode == "seq" else [xb]
        for xs in shards:
            t = xs.reshape(-1, xs.shape[-1])
            _, eids, _ = route(t, torch.from_numpy(p["router"]), cfg)
            _, keep = dispatch_slots(eids, E, capacity(t.shape[0], cfg))
            total += int((~keep).sum())
    return total


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_moe_ep_matches_the_reference(pool, ref, i):
    """Output, aux and the gradients of sum(y * w) + aux, every leaf and
    x, against the reference's ``moe_ep_fwd`` at the same mesh."""
    case = CASES[i]
    name, data, model, mode, fsdp, b, s, cf, skew = case
    cfg, mesh, dist, n_dp, per_rank = _case_inputs(i, case)
    outs = pool.run(mr.moe_ep_body, mesh, per_rank)
    want = ref.result()[name]
    y, grads = _assemble(outs, mesh, n_dp, fsdp)
    _close(y.numpy(), want["y"], OUT_TOL, "y")
    for o in outs:
        _close(o[1].numpy(), want["aux"], AUX_TOL, "aux")
    for k, g in grads.items():
        w = np.asarray(want["grads"][k], np.float32)
        _close(g.numpy(), w, GRAD_TOL * max(1.0, float(np.abs(w).max())),
               k)
    if skew:
        p, x, _ = moe_inputs(i, b, s, skew)
        assert _drops(x, p, cfg, mesh, "rep" if mode == "rep" else "seq",
                      n_dp) > 0


def _model_inputs(jparams, cfg, mesh, dist, toks, labels):
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    specs = expert_param_specs(params, cfg, mesh)
    per_rank = []
    for r in range(mesh.size):
        i = rank_coords(mesh, r)["data"]
        rows = slice(2 * i, 2 * i + 2)
        per_rank.append((shard_for_rank(params, specs, mesh, r),
                         torch.tensor(toks[rows]),
                         torch.tensor(labels[rows]), cfg, dist))
    return params, per_rank


def test_model_forward_and_loss_with_dist_match_the_reference(
        pool, ref, grads_file):
    """Reduced Moonlight at mesh (2, 2), 4 x 8 tokens: ``forward(dist=)``'s
    logits and aux against the reference's ``forward(dist=)``;
    ``loss_fn(dist=, aux_weight=0)`` and its gradients against the
    reference's local ``loss_fn(aux_weight=0)`` and ``jax.grad`` of it
    (nothing drops at capacity factor 4); the loss with the aux against
    the reference's CE plus 0.01 x the aux of its ``forward(dist=)`` (its
    own ``loss_fn(dist=)`` raises under this JAX, ROADMAP Queue C)."""
    from repro_torch.tree import named_leaves
    want = ref.result()["model"]
    jcfg = jx_reduced(jx_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    dist = MeshContext(mesh, ("data",), "model")
    toks, labels = np.array(want["tokens"]), np.array(want["labels"])
    params, per_rank = _model_inputs(jparams, cfg, mesh, dist, toks, labels)
    outs = pool.run(mr.model_ep_body, mesh, per_rank)
    logits = torch.cat([outs[0]["logits"], outs[2]["logits"]])
    _close(logits.numpy(), want["logits"], 1e-4, "logits")
    for o in outs:
        _close(o["aux"].numpy(), want["aux_ep"], AUX_TOL, "aux")
    loss0 = (float(outs[0]["loss0"]) + float(outs[2]["loss0"])) / 2
    assert abs(loss0 - want["loss0"]) < 1e-5
    ce = (float(outs[0]["ce"]) + float(outs[2]["ce"])) / 2
    loss = (float(outs[0]["loss"]) + float(outs[2]["loss"])) / 2
    assert abs(loss - (want["ce"] + 0.01 * want["aux_ep"])) < 1e-5
    assert abs(ce - want["ce"]) < 1e-5
    # gradients: the reference's local jax.grad, unstacked into the port's
    # layout; experts meaned over the data ranks and joined over the model
    # ranks, every other leaf meaned over the data ranks
    with np.load(grads_file) as z:
        jgrads = _unflatten_reference(jparams, z)
    want_g = dict(named_leaves(bridge.params_from_jax(jgrads, cfg,
                                                      device="cpu")))
    for key, w in want_g.items():
        leaf = key.split("/")[-1]
        blocks = []
        for j in range(2):
            parts = [outs[2 * i + j]["grads"][key] for i in range(2)]
            blocks.append(sum(parts) / 2)
        if "moe" in key and leaf in ("w_in", "w_gate", "w_out"):
            got = torch.cat(blocks, 0)
        else:
            torch.testing.assert_close(blocks[0], blocks[1], rtol=0,
                                       atol=1e-6)
            got = blocks[0]
        _close(got.numpy(), w.numpy(),
               GRAD_TOL * max(1.0, float(w.abs().max())), key)


def _unflatten_reference(jparams, z):
    flat, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    return jax.tree_util.tree_unflatten(
        treedef, [z[jax.tree_util.keystr(k)] for k, _ in flat])


def test_zz_the_pool_closes(pool):
    """Last in the module: the shared pool's ranks end with it."""
    assert all(p.is_alive() for p in pool.procs)
    pool.close()
    assert not multiprocessing.active_children()
