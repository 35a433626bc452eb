"""The port's serving engine on the cross-attention stacks (reduced
Llama-3.2-Vision-11B and SeamlessM4T-medium) against the JAX package, in
f32 on the CPU.

The reference serves both on the contiguous cache only, with a cross
cache of one zero row a layer (``src_len=1``: no served body passes image
or frame inputs), so served cross-attention attends over that row.  The
port's tokens and scheduling counters equal the JAX ``ServeEngine``'s
under ``plan="jit"``; every launch plan serves the jit tokens, the fused
plan through the norm windows of ``models.norm_launches``; speculation
keeps the plain greedy tokens, as the reference's does on both; and the
paged pool refuses both stacks with the reference's ``ValueError``.
Every ``xgate`` is 0.5 (the reference's 0 would zero the vision cross
layers, here and wherever they are checked).
"""
import contextlib
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
from repro_torch.models import (attention_launches, make_cache,
                                make_paged_cache, norm_launches)
from repro_torch.telemetry.characterize import _decode_trace

torch.set_num_threads(2)
VISION, SEAMLESS = "llama-3.2-vision-11b", "seamless-m4t-medium"
NAMES = (VISION, SEAMLESS)
MAX_LEN = 48
GATE = 0.5
COUNTERS = ("prefills", "decode_steps", "tokens_out", "prefill_chunks",
            "preemptions")
PLENS = (8, 13, 5, 16)
_MODELS: dict = {}
_JIT: dict = {}


def _model(name):
    if name not in _MODELS:
        jcfg, cfg = jx_reduced(jx_get_config(name)), reduced(get_config(name))
        tree = jax.tree.map(np.asarray,
                            jx_init_params(jax.random.PRNGKey(0), jcfg))
        for slot in tree["blocks"].values():
            if "xgate" in slot:
                slot["xgate"] = np.full_like(slot["xgate"], GATE)
        params = bridge.params_from_jax(tree, cfg, device="cpu")
        _MODELS[name] = (jcfg, cfg, jax.tree.map(jax.numpy.asarray, tree),
                         params)
    return _MODELS[name]


def _requests(cls, plens, vocab, seed, budget=5):
    rng = np.random.default_rng(seed)
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=budget) for i, n in enumerate(plens)]


def _jit(name):
    """The JAX engine's and the port's jit runs over the same requests:
    (reference engine, its done requests, port engine, its done)."""
    if name not in _JIT:
        jcfg, cfg, jparams, params = _model(name)
        opts = dict(max_batch=2, max_len=MAX_LEN)
        jeng = JxServeEngine(jcfg, jparams, plan="jit",
                             platform="Intel+H100", **opts)
        jdone = jeng.run(_requests(JxRequest, PLENS, cfg.vocab_size, 1))
        eng = ServeEngine(cfg, params, device="cpu", **opts)
        done = eng.run(_requests(Request, PLENS, cfg.vocab_size, 1))
        _JIT[name] = (jeng, jdone, eng, done)
    return _JIT[name]


@pytest.mark.parametrize("name", NAMES)
def test_tokens_equal_the_reference_engine(name):
    jeng, jdone, eng, done = _jit(name)
    assert [(r.rid, r.status, r.generated) for r in done] == \
        [(r.rid, r.status, r.generated) for r in jdone]
    assert all(r.status == "done" for r in done)
    for field in COUNTERS:
        assert getattr(eng.stats, field) == getattr(jeng.stats, field), field
    # one zero cross row a cross layer, as the reference's engine builds it
    crossed = [c for c in eng.cache if "cross_k" in c]
    assert crossed and all(c["cross_k"].shape[1] == 1 for c in crossed)


@pytest.mark.parametrize("plan", ["eager", "whole_graph", "chain", "auto",
                                  "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_launch_plans_serve_jit_tokens(name, plan):
    """Every launch plan serves the jit engine's tokens (the reference's);
    the fused plan finds the model's norm windows in every traced call,
    ``norm_x`` and the ``xattn`` slot's norm1 with the residual add before
    them."""
    _, cfg, _, params = _model(name)
    _, jdone, _, _ = _jit(name)
    eng = ServeEngine(cfg, params, plan=plan, max_batch=2, max_len=MAX_LEN,
                      device="cpu")
    done = eng.run(_requests(Request, PLENS, cfg.vocab_size, 1))
    assert [r.generated for r in done] == [r.generated for r in jdone]
    if plan == "fused":
        for pf in eng.backend._planned_fns.values():
            hits = {n: pf.rule_names.count(n) for n in set(pf.rule_names)}
            assert hits == norm_launches(cfg), hits


@pytest.mark.parametrize("name", NAMES)
def test_speculative_tokens_equal_plain_greedy(name):
    """The reference's speculative engine keeps its plain greedy tokens on
    both stacks; the port's speculative tokens equal them.  Its verify
    runs the cross layers through ``flash_attention`` (every query over
    all T source positions)."""
    jcfg, cfg, jparams, params = _model(name)
    opts = dict(max_batch=2, max_len=MAX_LEN)
    plain = [r.generated for r in sorted(_jit(name)[1], key=lambda r: r.rid)]
    jeng = JxServeEngine(jcfg, jparams, plan="jit", speculative=True,
                         spec_k=4, **opts)
    done = jeng.run(_requests(JxRequest, PLENS, cfg.vocab_size, 1))
    assert [r.generated for r in sorted(done, key=lambda r: r.rid)] == plain
    eng = ServeEngine(cfg, params, device="cpu", speculative=True, spec_k=4,
                      **opts)
    done = eng.run(_requests(Request, PLENS, cfg.vocab_size, 1))
    assert [r.generated for r in sorted(done, key=lambda r: r.rid)] == plain
    assert eng.stats.spec_rounds > 0
    assert all(c["cross_k"].shape[1] == 1 for c in eng.draft_cache
               if "cross_k" in c)


@pytest.mark.parametrize("name", NAMES)
def test_paged_pool_refuses_with_the_reference_words(name):
    """``make_paged_cache``, ``ServeEngine(cache="paged")`` and ``serve
    --cache paged`` raise the reference's ``ValueError``, word for word."""
    from repro.models import make_paged_cache as jx_make_paged_cache
    jcfg, cfg, _, params = _model(name)
    with pytest.raises(ValueError) as jerr:
        jx_make_paged_cache(jcfg, 8, 4)
    for call in (
            lambda: make_paged_cache(cfg, 8, 4, device="cpu"),
            lambda: ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                                device="cpu", cache="paged", block_size=4),
            lambda: serve.main(["--arch", name, "--reduced", "--device",
                                "cpu", "--cache", "paged", "--requests",
                                "1", "--no-warmup"])):
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(jerr.value)


def test_serve_cli_and_the_decode_trace_take_the_new_configs():
    """``serve --arch`` serves both reduced stacks; the characterization's
    traced decode step holds the cross layers over a one-row cross cache,
    their decode kernels beside the self-attention's."""
    for arch in NAMES:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, done = serve.main(["--arch", arch, "--reduced", "--device",
                                  "cpu", "--requests", "2", "--max-new", "3",
                                  "--no-warmup"])
        rep = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rep["arch"] == arch and rep["tokens_out"] == 6
        assert all(len(r.generated) == 3 for r in done)
        _, cfg, _, params = _model(arch)
        trace = _decode_trace(cfg, params, 2, 16, torch.device("cpu"))
        ops = [k.operator for k in trace.kernels
               if k.name == "decode_attention"]
        assert len(ops) == attention_launches(cfg)
        assert sum("xattn" in op for op in ops) == (
            cfg.n_layers if cfg.n_encoder_layers else cfg.n_superblocks)
    cache = make_cache(reduced(get_config(SEAMLESS)), 2, 8, device="cpu")
    assert cache[0]["cross_k"].shape == (2, 0, 4, 16)
