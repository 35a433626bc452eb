"""The GPipe schedule over gloo rank processes on the CPU, against the
reference's sequential oracle ``repro.distributed.pipeline.
reference_forward`` (its multi-device ``pipeline_forward`` fails under
this JAX, ROADMAP Queue C), on the same parameters and microbatches, made
from a seed with numpy.  Also the rank pool's failure path: a rank that
dies or raises makes the call raise in the caller, and no rank process is
left behind.
"""
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multirank as mr
from repro.distributed.pipeline import \
    reference_forward as jx_reference_forward
from repro_torch.distributed.pipeline import (bubble_fraction,
                                              reference_forward)
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.distributed.ranks import RankPool, run_ranks
from repro_torch.launch.mesh import Mesh, make_host_mesh, rank_devices
from repro_torch.models import forward_blocks, init_params, pipeline_stages

torch.set_num_threads(2)
P_MAX = 4


def pipe_mesh(p: int) -> Mesh:
    return Mesh({"pipe": p}, rank_devices(p, "cpu"))


@pytest.fixture(scope="module")
def pool():
    with RankPool(P_MAX, device="cpu") as p:
        yield p


def _jx_tanh_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stages(p: int, d: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((p, d, d)) / np.sqrt(d)).astype(
                np.float32),
            "b": (rng.standard_normal((p, d)) * 0.1).astype(np.float32)}


def _run(pool, stage_fn, stacked: dict, x: np.ndarray) -> list:
    p = next(iter(stacked.values())).shape[0]
    per_stage = [{k: torch.from_numpy(v[s]) for k, v in stacked.items()}
                 for s in range(p)]
    return pool.run(stage_fn, pipe_mesh(p),
                    [(per_stage[s], torch.from_numpy(x)) for s in range(p)])


def test_pipeline_single_stage_degenerates(pool):
    """The reference test's case: one stage, w = 2 I, x ones (3, 2, 4)."""
    params = {"w": np.eye(4, dtype=np.float32)[None] * 2.0}
    x = np.ones((3, 2, 4), np.float32)
    outs = pool.run(mr.pipeline_stage_matmul, pipe_mesh(1),
                    [({"w": torch.from_numpy(params["w"][0])},
                      torch.from_numpy(x))])
    want = jx_reference_forward(lambda p, x_: x_ @ p["w"],
                                jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(outs[0].numpy(), 2 * x)


@pytest.mark.parametrize("p,n_micro", [(4, 6), (4, 2), (2, 5)])
def test_pipeline_matches_the_reference_oracle(pool, p, n_micro):
    """P stages of tanh(x W + b) over n_micro microbatches of 2 x 8 (also
    fewer microbatches than stages): every rank returns the last stage's
    outputs, within 1e-5 of the JAX ``reference_forward``."""
    stacked = _stages(p, 8, seed=p * 10 + n_micro)
    x = np.random.default_rng(n_micro).standard_normal(
        (n_micro, 2, 8)).astype(np.float32)
    outs = _run(pool, mr.pipeline_body, stacked, x)
    want = np.asarray(jx_reference_forward(
        _jx_tanh_stage, jax.tree.map(jnp.asarray, stacked), jnp.asarray(x)))
    for out in outs:
        assert out.shape == (n_micro, 2, 8)
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
    # the port's own oracle is the reference's
    mine = reference_forward(
        mr.tanh_stage, [{k: torch.from_numpy(v[s]) for k, v in
                         stacked.items()} for s in range(p)],
        torch.from_numpy(x))
    np.testing.assert_allclose(mine.numpy(), want, rtol=0, atol=1e-6)
    assert bubble_fraction(p, n_micro) == (p - 1) / (n_micro + p - 1)


def test_model_stages_keep_their_layer_indices(pool):
    """Reduced Gemma-2 (local and global attention alternating, window 8)
    in 2 stages of 3 layers: stage 1 begins on a global layer, so it must
    run its blocks as layers 3-5.  The pipelined output equals the whole
    stack's ``forward_blocks`` within 1e-5, and the stages do differ by
    index here: stage 1 run as layers 0-2 gives another output."""
    cfg = reduced(get_config("gemma2-27b"), n_layers=6)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    stages = pipeline_stages(params, 2)
    assert [first for first, _ in stages] == [0, 3]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 2, 16, cfg.d_model)).astype(np.float32))
    outs = pool.run(mr.model_stage_body, pipe_mesh(2),
                    [(stage, x, cfg) for stage in stages])
    with torch.no_grad():
        want = torch.stack([forward_blocks(params["blocks"], xi, cfg)
                            for xi in x])
        unshifted = torch.stack([forward_blocks(
            stages[1][1], forward_blocks(stages[0][1], xi, cfg), cfg)
            for xi in x])
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
    assert float((unshifted - want).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="do not split"):
        pipeline_stages(params, 4)


def test_a_dead_rank_raises_and_leaves_no_process():
    """A rank that exits mid-call (its peers wait for it in a collective)
    makes the call raise in the caller, naming it; every rank ends."""
    before = set(multiprocessing.active_children())
    mesh = make_host_mesh(data=2, model=1, device="cpu")
    with pytest.raises(RuntimeError, match="rank 1 exited"):
        run_ranks(mr.die_on_rank1, mesh, [(), ()], device="cpu",
                  timeout_s=60)
    assert set(multiprocessing.active_children()) == before


def test_a_raising_rank_raises_with_its_traceback():
    before = set(multiprocessing.active_children())
    mesh = make_host_mesh(data=2, model=1, device="cpu")
    with RankPool(2, device="cpu", timeout_s=60) as pool:
        with pytest.raises(RuntimeError, match="rank 0 refuses"):
            pool.run(mr.raise_on_rank0, mesh, [(), ()])
        assert pool.closed
        with pytest.raises(RuntimeError, match="closed"):
            pool.run(mr.raise_on_rank0, mesh, [(), ()])
    assert set(multiprocessing.active_children()) == before


def test_zz_the_pool_closes(pool):
    """Last in the module: the shared pool's ranks end with it."""
    assert all(p.is_alive() for p in pool.procs)
    pool.close()
    assert not multiprocessing.active_children()
