"""The prefill and decode bundles (``launch.steps.build_serve_step``) on
gloo rank processes on the CPU, against the reference's single-device
``forward`` with a cache, in f32.

Reduced configs, a batch of 4 over a 16-position cache: a prefill of 8
tokens at cache index 0, then one decode step at index 8 through the
cache the prefill left.  The logits, the vocabulary blocks of the ranks
joined (the reference's ``out_shardings`` ``P(dp, None, "model")``),
agree with the reference's within 1e-4.  InternLM2-20B, Moonlight and
Jamba (the latter two with the experts expert-parallel in decode, "rep")
and RWKV-6 (its state split by heads) on (data 2, model 2), InternLM2 on
(pod 2, data 1, model 2); and the split-sequence path: with one kv head
(it cannot split over the model axis) and ``KV_REPLICATE_BUDGET`` set
below the cache's bytes, ``cache_specs`` splits the cache along T, the
decode step's attention is the partial softmax combined over the model
axis, and the query heads still split (``kv_sel``): InternLM2, Gemma-2
(a window, soft-capped scores), Llama-3.2-Vision (a cross cache, split
too) and SeamlessM4T (the encoder, whole on each rank).  The vocabulary
is 512, so that it splits.  No rank outlives the module.
"""
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro_torch import bridge
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.distributed import sharding
from repro_torch.distributed.ranks import RankPool
from repro_torch.launch.mesh import make_host_mesh, rank_coords
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import make_cache

torch.set_num_threads(2)
TOL = 1e-4
B, S, T = 4, 8, 16

# (arch, one kv head and a tiny replicate budget, (pod, data, model))
CASES = [
    ("internlm2-20b", False, (0, 2, 2)),
    ("internlm2-20b", False, (2, 1, 2)),
    ("moonshot-v1-16b-a3b", False, (0, 2, 2)),
    ("jamba-1.5-large-398b", False, (0, 2, 2)),
    ("rwkv6-3b", False, (0, 2, 2)),
    ("internlm2-20b", True, (0, 2, 2)),
    ("gemma2-27b", True, (0, 2, 2)),
    ("llama-3.2-vision-11b", True, (0, 2, 2)),
    ("seamless-m4t-medium", True, (0, 2, 2)),
]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


def _enc(cfg, rng):
    el = cfg.n_frontend_tokens
    if not (cfg.n_encoder_layers or cfg.frontend == "vision_patches"):
        return {}, 1
    x = rng.standard_normal((B, el, cfg.d_model)).astype(np.float32)
    name = "encoder_tokens" if cfg.n_encoder_layers else "frontend_embeds"
    return {name: x}, el


def _joined(outs, mesh):
    """The global (B, S, V) logits from the ranks' (row block, vocabulary
    block) pieces."""
    dp = [a for a in mesh.shape if a != "model"]
    rows = {}
    for r, o in enumerate(outs):
        c = rank_coords(mesh, r)
        i = 0
        for a in dp:
            i = i * mesh.shape[a] + c[a]
        rows.setdefault(i, {})[c["model"]] = o[0]
    return torch.cat([torch.cat([rows[i][m] for m in sorted(rows[i])], -1)
                      for i in sorted(rows)], 0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-"
                         f"{'split' if c[1] else 'whole'}-"
                         f"{'x'.join(map(str, c[2]))}")
def test_prefill_and_decode_match_the_reference(pool, case, monkeypatch):
    arch, split, (pod, data, model) = case
    over = {"vocab_size": 512}
    if split:
        over["n_kv_heads"] = 1
        monkeypatch.setattr(sharding, "KV_REPLICATE_BUDGET", 1.0)
    cfg = reduced(get_config(arch), **over)
    jcfg = jx_reduced(jx_get_config(arch), **over)
    mesh = make_host_mesh(data=data, model=model, pod=pod, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    nxt = rng.integers(0, 512, (B, 1)).astype(np.int32)
    enc, el = _enc(cfg, rng)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    jcache = jx_make_cache(jcfg, B, T, src_len=el)
    want1, _, jcache = jax.jit(lambda p, c, t, **kw: jx_forward(
        p, t, jcfg, cache=c, cache_index=jnp.int32(0), **kw))(
            jparams, jcache, toks, **enc)
    want2, _, _ = jax.jit(lambda p, c, t: jx_forward(
        p, t, jcfg, cache=c, cache_index=jnp.int32(S)))(jparams, jcache, nxt)
    pre = build_serve_step(cfg, ShapeSpec("p", T, B, "prefill"), mesh,
                           mode="prefill")
    dec = build_serve_step(cfg, ShapeSpec("d", T, B, "decode"), mesh,
                           mode="decode")
    assert pre.plan.seq_cache == dec.plan.seq_cache == split
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    cache = make_cache(cfg, B, T, src_len=el, device="cpu")
    ins = (params, torch.tensor(toks), cache, 0,
           *(torch.tensor(v) for v in enc.values()))
    per = [pre.rank_inputs(ins, r) for r in range(mesh.size)]
    outs = pool.run(pre.fn, mesh, per)
    got = _joined(outs, mesh)
    assert float((got - torch.tensor(np.asarray(want1))).abs().max()) < TOL
    caches = [o[1] for o in outs]
    step = dec.rank_inputs((params, torch.tensor(nxt), cache, S), 0)
    per = [(per[r][0], dec.rank_inputs((params, torch.tensor(nxt), cache,
                                        S), r)[1], caches[r], step[3])
           for r in range(mesh.size)]
    outs = pool.run(dec.fn, mesh, per)
    got = _joined(outs, mesh)
    assert float((got - torch.tensor(np.asarray(want2))).abs().max()) < TOL


def test_zz_the_pool_closes(pool):
    """Last in the module: the ranks end with the pool."""
    pool.close()
    assert not multiprocessing.active_children()
