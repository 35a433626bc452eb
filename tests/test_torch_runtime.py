"""The launch-plan runtime of the port against the reference, on the CPU.

Reduced SmolLM and RWKV-6 (2 layers, f32) with the reference's weights
bridged bit for bit, served under every planned strategy (``eager``,
``whole_graph``, ``chain``, ``auto``, ``fused``) beside ``jit``:

  * greedy tokens equal the JAX ``ServeEngine``'s jit tokens (which its
    own tests hold equal to every plan's; each of its plans is run beside
    the port's same plan in ``tests/test_torch_plan_parity.py`` and
    ``tests/test_torch_skip.py``) and the port's jit
    tokens, on the contiguous cache, the paged bf16 pool and an int8 pool
    under pressure; RWKV-6 at prompts of its bucket length, where the
    reference pads nothing;
  * RWKV-6's fused plan has the reference's 2L+1 windows per call (the
    SmolLM rule hits against the reference's fused engine:
    ``tests/test_torch_skip.py``);
  * dispatches per decode step order eager > chain > auto >= whole_graph
    = 1, chain's modeled TKLQT is below eager's, attribution is complete;
  * last-position logits of a planned prefill and decode step within 1e-4
    of ``repro.models.forward``;
  * tracing leaves the cache untouched, and the plans replay after
    ``reset()``; the per-aten costs of a product equal the reference's
    ``dot_general`` FLOPs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core.tracing import trace_fn as jx_trace_fn
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.tracing import trace_fn
from repro_torch.inference.backends import LocalBackend
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.models import make_cache

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
PLANS = ("eager", "whole_graph", "chain", "auto", "fused")
MAX_LEN = 32


def _bridged(arch):
    jcfg = jx_reduced(jx_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def smollm():
    return _bridged("smollm-360m")


@pytest.fixture(scope="module")
def rwkv():
    return _bridged("rwkv6-3b")


def _requests(cls, vocab, shared_prefix=False, lengths=(5, 8, 11, 14)):
    rng = np.random.default_rng(5)
    head = [int(t) for t in rng.integers(0, vocab, 12)]
    reqs = []
    for i, n in enumerate(lengths):
        prompt = [int(t) for t in rng.integers(0, vocab, n)]
        if shared_prefix:
            prompt = head + prompt[:1 + i]
        budget = 12 if shared_prefix and i == 0 else 5 + i
        reqs.append(cls(i, prompt=prompt, max_new_tokens=budget))
    return reqs


CASES = {
    "contiguous": dict(),
    "paged_bf16": dict(cache="paged", block_size=8),
    "int8_pressure": dict(cache="paged", kv_dtype="int8", block_size=4,
                          num_blocks=8, prefill_chunk=4, offload="host",
                          share_prefix=True),
}


def _tokens(done):
    return [(r.rid, r.status, r.generated) for r in done]


def _serve_all(cfg, params, kw, reqs):
    """{plan: engine after serving ``reqs()``} for jit and every plan."""
    engines = {}
    for plan in ("jit",) + PLANS:
        eng = ServeEngine(cfg, params, plan=plan, device="cpu", **kw)
        eng.done = eng.run(reqs())
        engines[plan] = eng
    return engines


def _check_plans(engines, want) -> None:
    """Tokens, dispatch order, modeled TKLQT and attribution."""
    for plan, eng in engines.items():
        assert _tokens(eng.done) == want, plan
    per_step = {p: e.stats.dispatches_per_decode_step
                for p, e in engines.items()}
    assert (per_step["eager"] > per_step["chain"] > per_step["auto"]
            >= per_step["whole_graph"] == per_step["jit"] == 1.0), per_step
    tklqt = {p: e.stats.modeled_tklqt_s for p, e in engines.items()}
    assert tklqt["jit"] == 0.0 < tklqt["chain"] < tklqt["eager"], tklqt
    for plan in PLANS:
        fns = engines[plan].backend._planned_fns.values()
        assert fns and all(pf.attribution.complete for pf in fns), plan
        st = engines[plan].stats
        assert (st.fused_dispatches > 0) == (plan == "fused"), plan


@pytest.mark.parametrize("case", sorted(CASES))
def test_planned_tokens_match_jit_and_the_reference(smollm, case):
    jcfg, cfg, jparams, params = smollm
    kw = dict(max_batch=2, max_len=MAX_LEN, **CASES[case])
    shared = kw.get("share_prefix", False)
    jeng = JxServeEngine(jcfg, jparams, plan="jit", platform="Intel+H100",
                         **kw)
    want = _tokens(jeng.run(_requests(JxRequest, cfg.vocab_size, shared)))
    engines = _serve_all(cfg, params, kw,
                         lambda: _requests(Request, cfg.vocab_size, shared))
    _check_plans(engines, want)
    if case == "int8_pressure":
        st = engines["fused"].stats
        assert st.preemptions > 0 and st.prefix_adoptions > 0


def test_rwkv_planned_tokens_and_windows(rwkv):
    """RWKV-6 at prompts of 8 tokens (the reference's bucket, so its
    engine pads nothing): every plan's tokens equal the reference's; the
    fused plan finds the reference's 2L+1 norm windows per call (the bare
    first norm, then a residual norm at every other site: the port's model
    calls the legacy norm with the residual add inside)."""
    jcfg, cfg, jparams, params = rwkv
    kw = dict(max_batch=2, max_len=MAX_LEN)
    reqs = dict(lengths=(8, 8, 8))
    jeng = JxServeEngine(jcfg, jparams, plan="jit", **kw)
    want = _tokens(jeng.run(_requests(JxRequest, cfg.vocab_size, **reqs)))
    engines = _serve_all(cfg, params, kw,
                         lambda: _requests(Request, cfg.vocab_size, **reqs))
    _check_plans(engines, want)
    L = cfg.n_layers
    for pf in engines["fused"].backend._planned_fns.values():
        hits = {n: pf.rule_names.count(n) for n in set(pf.rule_names)}
        assert hits == {"rmsnorm": 1, "residual_rmsnorm": 2 * L}
        assert len(pf.rule_names) == 2 * L + 1


@pytest.mark.parametrize("plan", PLANS)
def test_planned_logits_match_the_reference_forward(smollm, plan):
    """A prefill of one slot and a decode step through the backend under
    ``plan``, against ``repro.models.forward`` on the same weights."""
    jcfg, cfg, jparams, params = smollm
    be = LocalBackend(cfg, params, max_batch=2, max_len=MAX_LEN, plan=plan,
                      device="cpu")
    cache = be.init_contiguous_cache()
    prompt = np.arange(3, 13)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = prompt
    logits, cache = be.prefill(cache, toks, 0, 10)
    jlog, _, jcache = jx_forward(jparams, jnp.asarray(prompt[None]), jcfg,
                                 cache=jx_make_cache(jcfg, 1, MAX_LEN),
                                 cache_index=jnp.zeros((), jnp.int32))
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlog[0, -1]),
                               atol=1e-4, rtol=0)
    nxt = np.array([[7], [0]])
    logits, cache = be.decode(cache, nxt, np.array([10, 0]))
    jlog, _, _ = jx_forward(jparams, jnp.asarray(nxt[:1]), jcfg,
                            cache=jcache, lengths=jnp.asarray([10]))
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlog[0, -1]),
                               atol=1e-4, rtol=0)
    assert be.last.dispatches == be.planned_decode.n_launches
    assert be.last.attribution.complete


def test_trace_leaves_the_cache_untouched_and_replays_after_reset(smollm):
    _, cfg, _, params = smollm
    cache = make_cache(cfg, 2, MAX_LEN, device="cpu")
    for layer in cache:
        for t in layer.values():
            t.normal_()
    before = [t.clone() for layer in cache for t in layer.values()]
    body = make_step_bodies(cfg).decode
    tr = trace_fn(lambda p, c, t, n: body(p, c, t, n)[0], params, cache,
                  torch.tensor([[3], [4]], dtype=torch.int32),
                  torch.tensor([5, 9], dtype=torch.int32))
    assert len(tr.kernels) > 0
    after = [t for layer in cache for t in layer.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    eng = ServeEngine(cfg, params, plan="fused", max_batch=2,
                      max_len=MAX_LEN, device="cpu")
    first = _tokens(eng.run(_requests(Request, cfg.vocab_size)))
    eng.reset()
    assert _tokens(eng.run(_requests(Request, cfg.vocab_size))) == first


@pytest.mark.parametrize("shapes", [((3, 5, 8), (8, 6)), ((2, 3, 4),
                                                           (2, 4, 5))])
def test_product_flops_equal_the_reference_dot_general(shapes):
    a, b = shapes
    x, w = np.ones(a, np.float32), np.ones(b, np.float32)
    jk = [k for k in jx_trace_fn(lambda p, q: p @ q, jnp.asarray(x),
                                 jnp.asarray(w)).kernels
          if k.name == "dot_general"]
    tk = [k for k in trace_fn(lambda p, q: p @ q, torch.from_numpy(x),
                              torch.from_numpy(w)).kernels
          if k.name in ("mm", "bmm")]
    assert len(jk) == len(tk) == 1
    assert tk[0].flops == jk[0].flops


def test_auto_plan_serves_the_reference_plans_tokens():
    """The auto plan beside the reference's auto plan on its acceptance
    setup (``tests/test_torch_plan_parity.py``): the same tokens, and
    fewer dispatches per decode step than the trace has nodes."""
    from test_torch_plan_parity import check_same_plan, serve_both
    jcfg = jx_reduced(jx_get_config("smollm-360m"), n_layers=2)
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    jeng, eng = serve_both((jcfg, cfg, jparams, params), "auto")
    check_same_plan(jeng, eng)
    pf = eng.backend.planned_decode
    assert 1 <= eng.stats.dispatches_per_decode_step < len(pf.trace.kernels)



@pytest.mark.parametrize("n_layers", [2, 4])
def test_auto_picks_the_plan_kind_the_reference_picks_at_full_width(
        n_layers):
    """At SmolLM-360M's full width (bf16, batch 4, ``max_len`` 128, depth
    cut), ``Planner.auto`` over the port's decode trace and over the
    reference's own decode trace (abstract weights) both pick a chain over
    the cost-aware partition, whose modeled TKLQT is the higher.  Run with
    ``-s`` to print each candidate (modeled, ``Intel+H100``)."""
    import dataclasses
    import functools

    from repro.inference.backends.local import LocalBackend as JxBackend
    from repro.runtime.planner import Planner as JxPlanner
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime import Planner

    def show(who, trace, choice):
        print(f"{who} L={n_layers}: {len(trace.kernels)} nodes; "
              + "; ".join(f"{e.plan.strategy} L={e.plan.length} "
                          f"{e.plan.n_launches} dispatches, TKLQT "
                          f"{e.tklqt * 1e6:.1f} us, IL {e.il * 1e6:.1f} us"
                          for e in choice.evaluated))

    jcfg = dataclasses.replace(jx_get_config("smollm-360m"),
                               n_layers=n_layers)
    jparams = jax.eval_shape(
        lambda: jx_init_params(jax.random.PRNGKey(0), jcfg))
    jbe = JxBackend(jcfg, jparams, max_batch=4, max_len=128, plan="auto",
                    platform="Intel+H100")
    jtr = jx_trace_fn(functools.partial(jbe._decode_body, unroll=True),
                      jparams, jax.eval_shape(jbe.init_contiguous_cache),
                      jax.ShapeDtypeStruct((4, 1), jnp.int32),
                      jax.ShapeDtypeStruct((4,), jnp.int32))
    want = JxPlanner(jtr, "Intel+H100").auto()
    show("reference", jtr, want)

    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=n_layers)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, params, max_batch=4, max_len=128, plan="auto",
                      device="cpu")
    eng.run([Request(i, prompt=list(range(7, 19)), max_new_tokens=2)
             for i in range(4)])
    tr = eng.backend.planned_decode.trace
    got = Planner(tr, "Intel+H100").auto()
    show("port", tr, got)
    assert got.plan.strategy == want.plan.strategy == "chain"
    assert eng.backend.planned_decode.plan == got.plan
