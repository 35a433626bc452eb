"""The port's serving engine on reduced Moonlight and Kimi K2 (MoE
decoders) against the JAX package, in f32 on the CPU.

Both serve byte-identical greedy tokens to the JAX ``ServeEngine`` on the
contiguous cache and on the paged pool (bf16 and int8, chunked prefill),
with the same scheduling counters.  At the full configs' capacity factor
(1.25) the reference's speculative engine keeps its plain greedy tokens on
Moonlight, and the port's speculative tokens equal them.  Launch plans
serve the jit engine's tokens, the fused plan through the norm windows of
``models.norm_launches``.
"""
import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import init_params as jx_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.launch import serve
from repro_torch.models import norm_launches

torch.set_num_threads(2)
MOE = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
JAMBA = "jamba-1.5-large-398b"
MAX_LEN = 48
COUNTERS = ("prefills", "decode_steps", "tokens_out", "prefill_chunks",
            "preemptions")
CACHES = {"contiguous": {},
          "paged": dict(cache="paged", block_size=4),
          "int8": dict(cache="paged", block_size=4, kv_dtype="int8",
                       prefill_chunk=4)}
_MODELS: dict = {}


def _model(name, **moe_kw):
    key = (name, tuple(sorted(moe_kw.items())))
    if key not in _MODELS:
        jcfg, cfg = jx_reduced(jx_get_config(name)), reduced(get_config(name))
        if moe_kw:
            jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
        jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
        params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cfg, device="cpu")
        _MODELS[key] = (jcfg, cfg, jparams, params)
    return _MODELS[key]


def _requests(cls, plens, vocab, seed, budget=5):
    rng = np.random.default_rng(seed)
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=budget) for i, n in enumerate(plens)]


def _both(name, plens, seed, **kw):
    """(reference engine, its done requests, port engine, its done)."""
    jcfg, cfg, jparams, params = _model(name)
    opts = dict(max_batch=2, max_len=MAX_LEN, **kw)
    jeng = JxServeEngine(jcfg, jparams, plan="jit", platform="Intel+H100",
                         **opts)
    jdone = jeng.run(_requests(JxRequest, plens, cfg.vocab_size, seed))
    eng = ServeEngine(cfg, params, device="cpu", **opts)
    done = eng.run(_requests(Request, plens, cfg.vocab_size, seed))
    return jeng, jdone, eng, done


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("name", MOE)
def test_moe_tokens_equal_the_reference_engine(name, cache):
    jeng, jdone, eng, done = _both(name, (8, 13, 5, 16), 1, **CACHES[cache])
    assert [(r.rid, r.status, r.generated) for r in done] == \
        [(r.rid, r.status, r.generated) for r in jdone]
    assert all(r.status == "done" for r in done)
    for field in COUNTERS:
        assert getattr(eng.stats, field) == getattr(jeng.stats, field), field
    if cache == "int8":
        assert eng.stats.prefill_chunks > eng.stats.prefills


def test_speculative_moe_tokens_equal_plain_greedy():
    """A verify routes B*(k+1) tokens, a decode step B, so their
    capacities differ; at capacity factor 1.25 the reference's speculative
    engine keeps its plain greedy tokens on Moonlight, and so does the
    port's, on the contiguous cache and the paged pool."""
    jcfg, cfg, jparams, params = _model("moonshot-v1-16b-a3b",
                                        capacity_factor=1.25)
    plens = (8, 16, 5, 11)
    for kw in ({}, dict(cache="paged", block_size=4)):
        opts = dict(max_batch=2, max_len=MAX_LEN, **kw)
        toks = {}
        for spec in (False, True):
            jeng = JxServeEngine(jcfg, jparams, plan="jit", speculative=spec,
                                 spec_k=4, **opts)
            done = jeng.run(_requests(JxRequest, plens, cfg.vocab_size, 4,
                                      budget=9))
            toks[spec] = [r.generated for r in sorted(done,
                                                      key=lambda r: r.rid)]
        assert toks[True] == toks[False]
        eng = ServeEngine(cfg, params, device="cpu", speculative=True,
                          spec_k=4, **opts)
        done = eng.run(_requests(Request, plens, cfg.vocab_size, 4,
                                 budget=9))
        assert [r.generated for r in sorted(done, key=lambda r: r.rid)] \
            == toks[False]
        assert eng.stats.spec_rounds > 0


def test_launch_plans_serve_jit_tokens():
    name = "moonshot-v1-16b-a3b"
    """eager and fused serve the jit engine's tokens; fused finds the
    model's norm windows in every traced call, the final norm with the
    untied unembed's product."""
    _, cfg, _, params = _model(name)
    plens = (8, 11)
    kw = dict(max_batch=2, max_len=MAX_LEN, device="cpu")
    jit = ServeEngine(cfg, params, **kw).run(
        _requests(Request, plens, cfg.vocab_size, 5))
    want = norm_launches(cfg)      # the untied final norm: the unembed's
    for plan in ("eager", "fused"):
        eng = ServeEngine(cfg, params, plan=plan, **kw)
        done = eng.run(_requests(Request, plens, cfg.vocab_size, 5))
        assert [r.generated for r in done] == [r.generated for r in jit]
        if plan == "fused":
            for pf in eng.backend._planned_fns.values():
                hits = {n: pf.rule_names.count(n) for n in set(pf.rule_names)}
                assert hits == want, hits


def test_serve_cli_takes_the_new_configs():
    for arch in (*MOE, JAMBA):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, done = serve.main(["--arch", arch, "--reduced", "--device",
                                  "cpu", "--requests", "2", "--max-new", "3",
                                  "--no-warmup"])
        rep = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rep["arch"] == arch and rep["tokens_out"] == 6
        assert all(len(r.generated) == 3 for r in done)
