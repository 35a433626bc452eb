"""The dry run (``launch.dryrun``): one rank's step body traced on meta
tensors with a dry rank context, against the same body on real ranks and
the reference's records; and the tensor-parallel sweep priced from
abstract parameters.

* A reduced cell on a (data 2, model 2) mesh, train (InternLM2-20B, seq
  shard, vocabulary split) and decode (Moonlight, experts in parallel):
  every rank's dry trace (its kernels' outputs laid out as on the CPU)
  issues the same aten stream, counts the same FLOPs and bytes and
  records the same collectives (kind, bytes, group, axes) as the body run
  by that rank on the CPU under the same recorder.
* A full-size cell, ``smollm-360m x decode_32k x 16x16``, on the CPU with
  no byte of the model allocated: ``argument_bytes`` is the reference's
  per-rank shard bytes of its inputs (``param_specs``, ``cache_specs``
  and the tokens over ``jax.sharding.AbstractMesh``), and the cell's JSON
  record has the reference's keys (plus ``fits``), its ``roofline`` the
  keys of the reference's ``Roofline.to_dict()``.
* ``characterize --tp-sweep`` prices abstract parameters
  (``launch.steps.params_sds``): on reduced Llama-3.2-1B the sweep priced
  from them equals the sweep priced from materialized parameters, and
  full-size InternLM2-20B (39.7 GB in bf16, more than this host could
  hold) prices from them.
"""
import functools
import json
import math
import multiprocessing

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jcfgs
from repro.distributed import sharding as jsh
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import make_cache as jx_make_cache
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.distributed.dry import recorded_run
from repro_torch.distributed.ranks import RankPool
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import StepOptions, build_step, stack_blocks
from repro_torch.models import init_params, make_cache
from repro_torch.telemetry import characterize as char
from repro_torch.training.optim import opt_init

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


def _inputs(bundle, cfg):
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, device="cpu")
    b, s = bundle.shape.global_batch, bundle.shape.seq_len
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         dtype=torch.int32)
    if bundle.name == "train":
        opt = opt_init(bundle.plan.opt_cfg, stack_blocks(params, cfg))
        return params, opt, {"tokens": toks, "labels": toks}
    cache = make_cache(cfg, b, s, device="cpu")
    return params, toks[:, :1], cache, 3


@pytest.mark.parametrize("arch,kind", [("internlm2-20b", "train"),
                                       ("moonshot-v1-16b-a3b", "decode")])
def test_dry_trace_equals_the_ranks_run(pool, arch, kind):
    cfg = reduced(get_config(arch), vocab_size=512)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    bundle = build_step(cfg, ShapeSpec("c", 8, 4, kind), mesh,
                        options=StepOptions(microbatches=1))
    ins = _inputs(bundle, cfg)
    runs = pool.run(functools.partial(recorded_run, bundle.fn), mesh,
                    [bundle.rank_inputs(ins, r) for r in range(mesh.size)])
    for r, (ops, flops, nbytes, calls) in enumerate(runs):
        tr = dryrun.trace_rank(bundle, r, like="cpu")
        rec = tr["recorder"]
        assert rec.ops == ops, r
        assert rec.flops == flops and rec.bytes == nbytes, r
        assert tr["calls"] == [tuple(c) for c in calls], r
        assert calls and flops["f32"] > 0


def test_full_size_cell_matches_the_reference_bytes_and_keys(tmp_path):
    arch, shape = "smollm-360m", "decode_32k"
    rec = dryrun.run_cell(arch, shape, multi_pod=False,
                          out_dir=str(tmp_path), verbose=False)
    with open(tmp_path / f"{arch}__{shape}__16x16.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert set(rec) == {"arch", "shape", "mesh", "status", "t_lower_s",
                        "t_compile_s", "memory", "roofline", "options",
                        "fits"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    want_keys = jroof.Roofline(0, 0, 0, 0, 0, {}, 0, 0, 1, 1).to_dict()
    assert set(rec["roofline"]) == set(want_keys)
    # the reference's per-rank input bytes over the abstract mesh
    jcfg, jshape = jcfgs.get_config(arch), jcfgs.SHAPES[shape]
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = dict(mesh.shape)

    def shard_bytes(tree, specs):
        total = 0
        flat = jax.tree_util.tree_flatten(tree)[0]
        sflat = jax.tree_util.tree_flatten(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]
        for leaf, spec in zip(flat, sflat):
            n = leaf.size * leaf.dtype.itemsize
            for e in spec:
                axes = () if e is None else (
                    (e,) if isinstance(e, str) else e)
                n //= math.prod(sizes[a] for a in axes)
            total += n
        return total

    p_sds = jsteps.params_sds(jcfg)
    b, s = jshape.global_batch, jshape.seq_len
    cache = jax.eval_shape(lambda: jx_make_cache(jcfg, b, s, src_len=1))
    tok = jax.ShapeDtypeStruct((b, 1), np.int32)
    want = (shard_bytes(p_sds, jsh.param_specs(p_sds, jcfg, mesh))
            + shard_bytes(cache, jsh.cache_specs(cache, jcfg, mesh))
            + shard_bytes(tok, jsh.valid_spec(
                (b, 1), jax.sharding.PartitionSpec(("data",), None), mesh))
            + 4)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["fits"] and rec["memory"]["temp_bytes"] > 0
    r = rec["roofline"]
    assert r["flops"] > 0 and r["coll_count"] > 0 and r["n_chips"] == 256


def test_tp_sweep_prices_abstract_parameters():
    from repro_torch.launch.steps import params_sds
    cfg = reduced(get_config("llama-3.2-1b"))
    kw = dict(batches=[1, 4], tps=[1, 2], platforms=["Intel+H100"],
              max_len=32, device="cpu")
    real = char.tp_sweep(cfg, init_params(cfg, torch.Generator().manual_seed(
        0), device="cpu"), **kw)
    abstract = char.tp_sweep(cfg, params_sds(cfg), **kw)
    assert abstract == real
    big = get_config("internlm2-20b")
    sweep = char.tp_sweep(big, params_sds(big), batches=[1], tps=[1, 4],
                          platforms=["GH200"], max_len=16, device="cpu")
    assert [p["tp"] for p in sweep["points"]] == [1, 4]
    assert all(p["n_kernels"] > 0 for p in sweep["points"])


def test_zz_the_pool_closes(pool):
    """Last in the module: the ranks end with the pool."""
    pool.close()
    assert not multiprocessing.active_children()
