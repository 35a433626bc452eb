"""``plan="jit"`` (the port's default) against ``plan="eager"`` and the
reference, on the CPU.

On the CPU ``"jit"`` runs the same fixed-shape step bodies as on the card,
without capture (the graphs themselves are held against eager in
``tests/test_torch_cuda_graphs.py`` on the card).  Reduced SmolLM and
RWKV-6 (2 layers, f32) with the reference's weights bridged bit for bit:

  * greedy tokens byte-identical under both plans and to the JAX
    ``ServeEngine(plan="jit")``, on the contiguous cache, the paged bf16
    pool, and an int8 pool under pressure (preemption, host offload, prefix
    sharing, chunked prefill); RWKV-6 against the reference's unpadded
    incremental forward (its engine pads the prompt);
  * a paged decode step whose free slots (all-sentinel table rows) and
    whose row past its table drop their writes leaves every visible page
    as it was, also where a write clamped onto the last page of its row
    would land on the (page, offset) another row writes;
  * one dispatch per decode step under jit, and under eager one a node
    of the traced step, whose hand-written kernel nodes are the jit step's
    attention (or wkv6) launches: eager runs the norms as their plain
    versions, as the reference's planned modes do;
  * every launch-plan strategy but ``autotuned`` serves the jit tokens.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro.models import make_paged_cache as jx_make_paged_cache
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.inference.backends import LocalBackend
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.launch import serve
from repro_torch.models import make_paged_cache

torch.set_num_threads(2)
MAX_LEN = 32
ATOL = 2e-5


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


def _requests(cls, vocab, shared_prefix=False):
    """Four requests of ragged prompts; with ``shared_prefix`` every prompt
    starts with the same 12 tokens and the first decodes longer, so its
    blocks are live when the others are admitted."""
    rng = np.random.default_rng(5)
    head = [int(t) for t in rng.integers(0, vocab, 12)]
    reqs = []
    for i in range(4):
        prompt = [int(t) for t in rng.integers(0, vocab, 5 + 3 * i)]
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
COUNTERS = ("prefills", "decode_steps", "tokens_out", "prefill_chunks",
            "preemptions", "offload_bytes", "restore_bytes",
            "prefix_adoptions", "shared_prefix_tokens")


@pytest.mark.parametrize("case", sorted(CASES))
def test_jit_tokens_match_eager_and_the_reference(smollm, case):
    jcfg, cfg, jparams, params = smollm
    kw = dict(max_batch=2, max_len=MAX_LEN, **CASES[case])
    shared = kw.get("share_prefix", False)
    jeng = JxServeEngine(jcfg, jparams, plan="jit", platform="Intel+H100",
                         **kw)
    want = jeng.run(_requests(JxRequest, cfg.vocab_size, shared))
    runs = {}
    for plan in ("jit", "eager"):
        eng = ServeEngine(cfg, params, plan=plan, device="cpu", **kw)
        done = eng.run(_requests(Request, cfg.vocab_size, shared))
        assert [(r.rid, r.status, r.generated) for r in done] == \
            [(r.rid, r.status, r.generated) for r in want], plan
        for name in COUNTERS:
            assert getattr(eng.stats, name) == getattr(jeng.stats, name), \
                (plan, name)
        runs[plan] = eng
    st = runs["jit"].stats
    if case == "int8_pressure":
        assert st.preemptions > 0 and st.prefix_adoptions > 0
        assert st.offload_bytes == st.restore_bytes > 0
    assert runs["jit"].backend.graph_stats.captured == 0    # no capture here
    # and the caches after the run, every visible leaf bit for bit
    for a, b in zip(runs["jit"].cache, runs["eager"].cache):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def _incremental(jparams, jcfg, prompt, n_new):
    """Greedy tokens of the reference's forward, fed the prompt unpadded
    and then one token at a time."""
    cache = jx_make_cache(jcfg, 1, MAX_LEN, src_len=1)
    logits, _, cache = jx_forward(jparams, jnp.asarray([prompt], jnp.int32),
                                  jcfg, cache=cache,
                                  cache_index=jnp.zeros((), jnp.int32))
    seq = [int(jnp.argmax(logits[0, -1]))]
    for idx in range(len(prompt), len(prompt) + n_new - 1):
        logits, _, cache = jx_forward(
            jparams, jnp.asarray([[seq[-1]]], jnp.int32), jcfg, cache=cache,
            cache_index=jnp.asarray(idx, jnp.int32))
        seq.append(int(jnp.argmax(logits[0, 0])))
    return seq


def test_rwkv_jit_tokens_match_eager_and_the_incremental_forward(rwkv):
    jcfg, cfg, jparams, params = rwkv
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 11, 7)]
    got = {}
    for plan in ("jit", "eager"):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                          plan=plan, device="cpu")
        done = eng.run([Request(i, prompt=p, max_new_tokens=5)
                        for i, p in enumerate(prompts)])
        got[plan] = {r.rid: r.generated for r in done}
    assert got["jit"] == got["eager"]
    for i, p in enumerate(prompts):
        assert got["jit"][i] == _incremental(jparams, jcfg, p, 5), i


def _spy_launches(monkeypatch):
    """Count each wrapper's calls in its launch count, as a launch on the
    card would (on the CPU the wrappers run their plain versions, which
    count nothing)."""
    for name, fn in kernels.WRAPPERS.items():
        monkeypatch.setattr(fn, "launches", fn.launches)   # restored after

        def counted(*a, _fn=fn, **k):
            _fn.launches += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)


@pytest.mark.parametrize("arch", ["smollm", "rwkv"])
def test_dispatch_and_launch_accounting_under_both_plans(smollm, rwkv, arch,
                                                         monkeypatch):
    _, cfg, _, params = smollm if arch == "smollm" else rwkv
    _spy_launches(monkeypatch)
    L = cfg.n_layers
    want = ({"wkv6": L, "rmsnorm": 2 * L + 1} if arch == "rwkv" else
            {"rmsnorm_matmul": L, "residual_rmsnorm": L + 1,
             "decode_attention": L})
    per_step = {}
    for plan in ("jit", "eager"):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                          plan=plan, device="cpu")
        eng.run(_requests(Request, cfg.vocab_size)[:3])
        st = eng.stats
        if plan == "jit":
            per_step[plan] = {k: v for k, v in
                              st.kernel_launches_per_decode_step.items()
                              if v}
            assert st.decode_dispatches == st.decode_steps > 0
            assert st.dispatches_per_decode_step == 1.0
        else:   # one dispatch a node of the traced step, whose norms are
            # expanded into their plain versions: its hand-written kernel
            # nodes are the attention (or wkv6) launches alone
            pf = eng.backend.planned_decode
            names = [k.name for k in pf.trace.kernels]
            per_step[plan] = {k: names.count(k) for k in kernels.WRAPPERS
                              if k in names}
            assert st.dispatches_per_decode_step == len(names)
            assert st.dispatches_per_decode_step > 4 * sum(want.values())
    assert per_step["jit"] == want
    assert per_step["eager"] == {k: v for k, v in want.items()
                                 if k in ("wkv6", "decode_attention")}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_dropped_paged_writes_leave_the_visible_pool_alone(smollm, kv_dtype):
    """Rows 0 and 1 write valid tokens; row 2 is a free slot (its table
    row all sentinel); row 3 is past its table, whose last page is row 0's
    page, at the offset row 0 writes.  Every visible entry but the two
    valid writes keeps its bits, and those two equal the reference's."""
    jcfg, cfg, jparams, params = smollm
    pool, bs, nb = 12, 4, 3
    sentinel = pool
    tables = np.array([[3, 7, sentinel], [5, sentinel, sentinel],
                       [sentinel] * 3, [9, 10, 7]], np.int32)
    lengths = np.array([4, 2, 0, nb * bs], np.int32)   # row 0 -> (7, 0)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    jcache = jx_make_paged_cache(jcfg, pool, bs, dtype=jcfg.cdtype,
                                 kv_dtype=kv_dtype)
    # the same random prior contents in both pools
    fill = {}
    for name, leaf in jcache["slot0"]["self"].items():
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        fill[name] = (np.clip(np.round(a * 40), -127, 127).astype(np.int8)
                      if leaf.dtype == jnp.int8 else
                      np.abs(a) * 0.01 if "scale" in name else a)
        jcache["slot0"]["self"][name] = jnp.asarray(fill[name], leaf.dtype)
    _, _, jcache = jx_forward(jparams, jnp.asarray(toks), jcfg, cache=jcache,
                              lengths=jnp.asarray(lengths),
                              block_tables=jnp.asarray(tables))
    pools = {}
    for plan in ("jit", "eager"):
        cache = make_paged_cache(cfg, pool, bs, kv_dtype=kv_dtype,
                                 device="cpu")
        for i, layer in enumerate(cache):
            for name, t in layer.items():
                t.copy_(torch.from_numpy(fill[name][i]))
        be = LocalBackend(cfg, params, max_batch=4, max_len=nb * bs,
                          plan=plan, device="cpu")
        be.paged_decode(cache, toks, lengths, tables)
        pools[plan] = cache
    written = np.zeros((pool, bs), bool)
    written[7, 0] = written[5, 2] = True
    for a, b in zip(pools["jit"], pools["eager"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    for i, layer in enumerate(pools["jit"]):
        for name, t in layer.items():
            got = t.numpy()
            before = fill[name][i]
            assert np.array_equal(got[~written], before[~written]), name
            ref = np.asarray(jcache["slot0"]["self"][name][i])
            if name.endswith("pages") and kv_dtype == "int8":
                # int8 payloads may round one step apart
                assert np.abs(got[written].astype(int)
                              - ref[written].astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got[written], ref[written],
                                           atol=ATOL, rtol=1e-5)
            assert not np.array_equal(got[written], before[written]), name


@pytest.mark.parametrize("plan", ["autotuned"])
def test_launch_plan_strategies_stay_unported(smollm, plan):
    _, cfg, _, params = smollm
    with pytest.raises(ValueError, match="autotune"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, plan=plan,
                    device="cpu")


@pytest.fixture(scope="module")
def paged_reference(smollm):
    """The reference engine's tokens on the paged bf16 pool."""
    jcfg, cfg, jparams, _ = smollm
    jeng = JxServeEngine(jcfg, jparams, plan="jit", platform="Intel+H100",
                         max_batch=2, max_len=MAX_LEN, **CASES["paged_bf16"])
    return jeng.run(_requests(JxRequest, cfg.vocab_size))


@pytest.mark.parametrize("plan", ["chain", "auto", "whole_graph", "fused"])
def test_launch_plan_strategies_match_jit_and_the_reference(
        smollm, paged_reference, plan):
    """Each launch-plan strategy serves the jit plan's tokens, which are
    the reference engine's, on the paged bf16 pool; its dispatches per
    decode step are its plan's segments (``tests/test_torch_runtime.py``
    holds every plan in every cache mode)."""
    _, cfg, _, params = smollm
    kw = dict(max_batch=2, max_len=MAX_LEN, **CASES["paged_bf16"])
    want = paged_reference
    eng = ServeEngine(cfg, params, plan=plan, device="cpu", **kw)
    done = eng.run(_requests(Request, cfg.vocab_size))
    assert [(r.rid, r.generated) for r in done] == \
        [(r.rid, r.generated) for r in want]
    pf = eng.backend.planned_decode
    assert eng.stats.dispatches_per_decode_step == pf.n_launches
    assert (eng.stats.rule_hits != {}) == (plan == "fused")


def test_serve_cli_plans_agree():
    reps = {}
    for plan in ("jit", "eager", "whole_graph", "chain", "auto", "fused"):
        out = io.StringIO()
        argv = ["--reduced", "--device", "cpu", "--requests", "3",
                "--max-batch", "2", "--max-new", "4", "--no-warmup"]
        if plan != "jit":
            argv += ["--plan", plan]
        with contextlib.redirect_stdout(out):
            _, done = serve.main(argv)
        reps[plan] = (json.loads(out.getvalue().strip().splitlines()[-1]),
                      [r.generated for r in done])
    jit, jtoks = reps["jit"]
    for plan, (rep, toks) in reps.items():
        assert rep["plan"] == plan and toks == jtoks, plan
        assert (rep["modeled_tklqt_us"] > 0) == (plan != "jit"), plan
        assert ((rep["fused_dispatches_per_decode_step"] > 0)
                == (plan == "fused")), plan
    per_step = {p: r["dispatches_per_decode_step"]
                for p, (r, _) in reps.items()}
    assert (per_step["eager"] > per_step["chain"] > per_step["auto"]
            >= per_step["whole_graph"] == per_step["jit"] == 1.0), per_step
    assert jit["graphs_captured"] == 0 and jit["graph_memory_bytes"] == 0
