"""RWKV-6 beside attention in one stack, the port against the JAX package,
in f32 on the CPU.

Reduced ``rwkv6-3b`` with ``block_pattern`` ``("rwkv6", "attn")`` and
``("attn", "rwkv6")`` at 4 layers (two superblocks): no published model
has either, but the reference's ``_apply_slot`` takes any kind in any
slot, and so does the port's layer loop.  Reference weights go through
``repro_torch.bridge``.  The logits agree within 1e-4 of
``repro.models.forward`` (a full forward, a prefill into the cache and
decode steps); the greedy tokens equal the JAX ``ServeEngine``'s on the
contiguous cache at prompt lengths 8 and 16 (a recurrent stack is
prefilled at the exact prompt length, the reference pads to a power of
two); every launch plan serves the jit engine's tokens; the forward
launches the fused norm kernels where the reference's fused plan finds
its windows, its bare ``rmsnorm`` window (an RWKV-6 slot opening a
superblock) as a ``residual_rmsnorm`` without a residual; the paged pool,
speculation and the tensor-parallel backend refuse the stack.
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core.tracing import trace_fn
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro.runtime.rules import find_matches
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.models import (attention_launches, check_supported, forward,
                                make_cache, make_paged_cache, norm_launches)
from repro_torch.runtime import autotune as at

torch.set_num_threads(2)
ARCH = "rwkv6-3b"
PATTERNS = (("rwkv6", "attn"), ("attn", "rwkv6"))
IDS = ["rwkv6_attn", "attn_rwkv6"]
LAYERS = 4
ATOL = 1e-4
MAX_LEN = 48
# the reference's find_matches over one traced decode step at 4 layers,
# batch 2 (rule rmsnorm: a bare norm, lowered to residual_rmsnorm)
REFERENCE_WINDOWS = {
    ("rwkv6", "attn"): {"rmsnorm": 2, "residual_rmsnorm": 6,
                        "rmsnorm_matmul": 1},
    ("attn", "rwkv6"): {"residual_rmsnorm": 6, "rmsnorm_matmul": 3}}
_MODELS: dict = {}


def _model(pattern):
    """(jax cfg, port cfg, reference params, port params), one a
    pattern."""
    if pattern not in _MODELS:
        kw = dict(block_pattern=pattern, n_layers=LAYERS)
        jcfg = jx_reduced(jx_get_config(ARCH)).replace(**kw)
        cfg = reduced(get_config(ARCH)).replace(**kw)
        jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
        params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cfg, device="cpu")
        _MODELS[pattern] = (jcfg, cfg, jparams, params)
    return _MODELS[pattern]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


def _requests(cls, plens, vocab, seed, budget=5):
    rng = np.random.default_rng(seed)
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=budget) for i, n in enumerate(plens)]


@pytest.mark.parametrize("pattern", PATTERNS, ids=IDS)
def test_logits_match_the_reference(pattern):
    """A full forward, then a prefill into the cache and decode steps
    through it (attention slots write the contiguous KV, RWKV-6 slots
    step their state)."""
    jcfg, cfg, jparams, params = _model(pattern)
    check_supported(cfg)
    b, s = 2, 9
    toks = _tokens(1, (b, s + 3), cfg.vocab_size)
    full, _ = forward(params, torch.from_numpy(toks), cfg)
    _close(full, jx_forward(jparams, jnp.asarray(toks), jcfg)[0])
    cache = make_cache(cfg, b, MAX_LEN, device="cpu")
    jcache = jx_make_cache(jcfg, b, MAX_LEN)
    tl, cache = forward(params, torch.from_numpy(toks[:, :s]), cfg,
                        cache=cache)
    jl, _, jcache = jx_forward(jparams, jnp.asarray(toks[:, :s]), jcfg,
                               cache=jcache,
                               cache_index=jnp.zeros((), jnp.int32))
    _close(tl, jl)
    for step in range(3):
        lengths = np.full((b,), s + step, np.int32)
        tok = toks[:, s + step:s + step + 1]
        tl, cache = forward(params, torch.from_numpy(tok), cfg, cache=cache,
                            lengths=lengths)
        jl, _, jcache = jx_forward(jparams, jnp.asarray(tok), jcfg,
                                   cache=jcache, lengths=jnp.asarray(lengths))
        _close(tl, jl)
        _close(tl[:, 0], full[:, s + step].numpy())


@pytest.mark.parametrize("pattern", PATTERNS, ids=IDS)
def test_bucket_sized_prompts_match_the_reference_engine(pattern):
    jcfg, cfg, jparams, params = _model(pattern)
    plens = (8, 16, 8, 16)
    kw = dict(max_batch=2, max_len=MAX_LEN)
    jeng = JxServeEngine(jcfg, jparams, plan="jit", **kw)
    jdone = jeng.run(_requests(JxRequest, plens, cfg.vocab_size, 2))
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    assert eng.recurrent and eng.exact_prefill
    done = eng.run(_requests(Request, plens, cfg.vocab_size, 2))
    assert [(r.rid, r.generated) for r in done] == \
        [(r.rid, r.generated) for r in jdone]
    for field in ("prefills", "decode_steps", "tokens_out"):
        assert getattr(eng.stats, field) == getattr(jeng.stats, field)


def _planned_hits(eng) -> list:
    return [Counter(pf.rule_names) for pf in eng.backend._planned_fns.values()]


@pytest.mark.parametrize("pattern", PATTERNS, ids=IDS)
def test_every_plan_serves_the_jit_tokens(pattern):
    """eager, whole_graph, chain, auto, fused and autotuned (its table
    picking fused) serve jit's tokens; each call fused finds the
    reference's windows."""
    _, cfg, _, params = _model(pattern)
    kw = dict(max_batch=2, max_len=MAX_LEN, device="cpu")
    plens = (8, 11, 5)
    want = [r.generated for r in ServeEngine(cfg, params, **kw).run(
        _requests(Request, plens, cfg.vocab_size, 5))]
    table = at.PlanTable(arch=cfg.name, scenario="chatbot",
                         platform="Intel+H100", d_model=cfg.d_model)
    cand = at.CandidateResult(
        plan="fused", mean_decode_step_s=1e-3, decode_launch_tax_s=5e-4,
        dispatches_per_decode_step=10.0,
        fused_dispatches_per_decode_step=0.0, tokens_per_s=1e3,
        decode_steps=10)
    table.entries[2] = at.AutotuneEntry(batch=2, region="CPU-bound",
                                        selected="fused", candidates=[cand])
    for plan in ("eager", "whole_graph", "chain", "auto", "fused",
                 "autotuned"):
        extra = {"plan_table": table.to_dict()} if plan == "autotuned" \
            else {}
        eng = ServeEngine(cfg, params, plan=plan, **kw, **extra)
        got = [r.generated for r in eng.run(
            _requests(Request, plens, cfg.vocab_size, 5))]
        assert got == want, plan
        if plan in ("fused", "autotuned"):
            hits = _planned_hits(eng)
            assert len(hits) == 4      # prefills of 8, 11 and 5, the decode
            assert all(h == REFERENCE_WINDOWS[pattern] for h in hits), hits


def _spy(monkeypatch):
    calls = Counter()
    for name in kernels.WRAPPERS:
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


@pytest.mark.parametrize("call", ["decode", "prefill"])
@pytest.mark.parametrize("pattern", PATTERNS, ids=IDS)
def test_launches_equal_the_reference_fused_plan(pattern, call,
                                                 monkeypatch):
    """The forward launches ``rmsnorm_matmul`` and ``residual_rmsnorm`` at
    the windows the reference's fused plan finds in its own traced call,
    its bare ``rmsnorm`` as a ``residual_rmsnorm``; the attention kernel
    at every attention slot and ``wkv6`` at every RWKV-6 slot."""
    jcfg, cfg, jparams, params = _model(pattern)
    b = 2
    if call == "decode":
        s = 1
        lengths = np.asarray([4, 5], np.int32)
        jkw, tkw = dict(lengths=jnp.asarray(lengths)), dict(lengths=lengths)
    else:
        s, jkw, tkw = 6, {}, {}

    def fn(p, c, t):
        return jx_forward(p, t, jcfg, cache=c, unroll=True, **jkw)[0]
    trace = trace_fn(fn, jparams, jx_make_cache(jcfg, b, MAX_LEN),
                     jnp.zeros((b, s), jnp.int32))
    ref = Counter(m.rule_name for m in find_matches(trace, verify=False))
    assert ref == REFERENCE_WINDOWS[pattern]
    calls = _spy(monkeypatch)
    forward(params, torch.zeros((b, s), dtype=torch.int32), cfg,
            cache=make_cache(cfg, b, MAX_LEN, device="cpu"), **tkw)
    launched = Counter(ref)
    launched["residual_rmsnorm"] += launched.pop("rmsnorm", 0)
    assert dict(launched) == norm_launches(cfg)
    attention = "decode_attention" if call == "decode" else "flash_attention"
    assert calls == {**launched, attention: attention_launches(cfg),
                     "wkv6": LAYERS // 2}
    assert attention_launches(cfg) == LAYERS // 2


@pytest.mark.parametrize("pattern", PATTERNS, ids=IDS)
def test_paged_speculation_and_tensor_parallel_refuse(pattern):
    _, cfg, _, params = _model(pattern)
    with pytest.raises(ValueError, match="pure-attention stacks only"):
        make_paged_cache(cfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                    cache="paged", block_size=4)
    with pytest.raises(ValueError, match="recurrent"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                    speculative=True)
    with pytest.raises(ValueError, match="pure-attention decoder stacks"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                    tp=2)
