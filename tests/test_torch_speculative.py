"""The port's speculative decoding against the reference's, on the CPU.

Every case of ``tests/test_speculative.py`` run against the port's modules
(accept rule, depth policy, draft validation, engine options, the
truncation test, the pool's trim, counter invariants, ``reset``, the
depth policy turning rounds off), and on reduced SmolLM-360M (2 layers,
f32, the reference's weights bridged bit for bit):

  * the port's speculative tokens equal the JAX engine's plain greedy
    tokens and its speculative tokens, on the contiguous cache and the
    paged pool, seeds 0 and 1, with the JAX speculative engine's counters
    (rounds, proposed, accepted, corrections, draft dispatches, tokens,
    decode steps);
  * the same with the reference's adversarial draft (an untied, shifted
    unembed that the target rejects nearly every round);
  * speculation on a recurrent stack (RWKV-6) and on an encoder (BERT)
    raises and names the fault (the reference's speculative tokens part
    from its greedy ones there);
  * ``launch.serve --speculative`` with its validation errors.

Preemption, the paged rollback, Gemma-2 and ``spec_sweep`` are in
``test_torch_spec_serve.py``.
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
from repro.inference import speculative as jx_spec
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.kvcache.allocator import BlockPool as JxBlockPool
from repro.models import init_params as jx_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.speculative import (accept_lengths,
                                               default_draft_config,
                                               draft_params_from_target,
                                               greedy_accept,
                                               is_truncation_of, pick_spec_k,
                                               validate_draft)
from repro_torch.kvcache import BlockPool
from repro_torch.launch import serve
from repro_torch.models import init_params

torch.set_num_threads(2)
COUNTERS = ("spec_rounds", "proposed", "accepted", "corrections",
            "draft_dispatches", "tokens_out", "decode_steps")
PAGED = dict(cache="paged", block_size=4, num_blocks=64)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jx_reduced(jx_get_config("smollm-360m"), n_layers=2)
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def reject_draft(tiny):
    """The reference's adversarial draft on both sides: truncated-target
    params with an UNTIED, shifted unembed."""
    jcfg, cfg, jparams, params = tiny
    jdcfg = jx_spec.default_draft_config(jcfg).replace(tie_embeddings=False)
    jdparams = dict(jx_spec.draft_params_from_target(jparams, jdcfg))
    jdparams["lm_head"] = jnp.roll(jparams["embed"], 1, axis=0).T
    dcfg = default_draft_config(cfg).replace(tie_embeddings=False)
    dparams = dict(draft_params_from_target(params, dcfg))
    dparams["lm_head"] = torch.roll(params["embed"], 1, 0).T.contiguous()
    return (jdcfg, jdparams), (dcfg, dparams)


def _requests(cls, vocab, n=3, new=10, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(i, prompt=[int(t) for t in rng.integers(1, vocab, 5 + i)],
                max_new_tokens=new) for i in range(n)]


def _toks(eng, cls, vocab, **kw):
    done = eng.run(_requests(cls, vocab, **kw))
    return {r.rid: list(r.generated) for r in done}


_REF: dict = {}


def _reference(tiny, key, seed=7, **kw):
    """The JAX engine's tokens (and counters) for one configuration,
    computed once per module."""
    if (key, seed) not in _REF:
        jcfg, _, jparams, _ = tiny
        eng = JxServeEngine(jcfg, jparams, max_batch=4, max_len=64, **kw)
        toks = _toks(eng, JxRequest, jcfg.vocab_size, seed=seed)
        _REF[(key, seed)] = toks, {c: getattr(eng.stats, c)
                                   for c in COUNTERS}
    return _REF[(key, seed)]


def _port(tiny, seed=7, **kw):
    _, cfg, _, params = tiny
    eng = ServeEngine(cfg, params, max_batch=4, max_len=64, device="cpu",
                      **kw)
    return _toks(eng, Request, cfg.vocab_size, seed=seed), eng


# ------------------------------------------------------------ accept rule
@pytest.mark.parametrize("draft,target,n,emitted", [
    ([5, 9, 2], [5, 9, 2, 7], 3, [5, 9, 2, 7]),     # full accept + bonus
    ([5, 9, 2], [4, 9, 2, 7], 0, [4]),              # full reject
    ([5, 9, 2], [5, 9, 8, 7], 2, [5, 9, 8]),        # mid-window reject
])
def test_greedy_accept(draft, target, n, emitted):
    assert greedy_accept(draft, target) == (n, emitted)
    assert jx_spec.greedy_accept(draft, target) == (n, emitted)


def test_greedy_accept_shape_mismatch():
    with pytest.raises(ValueError, match="k\\+1"):
        greedy_accept([5, 9], [5, 9])


def test_accept_lengths_vectorized():
    draft = np.array([[5, 9, 2], [5, 9, 2], [1, 2, 3]])
    tgt = np.array([[5, 9, 2, 7], [5, 8, 2, 7], [0, 2, 3, 4]])
    assert accept_lengths(draft, tgt).tolist() == [3, 1, 0]
    assert (accept_lengths(draft, tgt).tolist()
            == jx_spec.accept_lengths(draft, tgt).tolist())


# ------------------------------------------------------------ depth policy
@pytest.mark.parametrize("batch,max_k,inflection,want", [
    (1, 8, None, 8), (4, 8, 16, 8),                 # deep: CPU-bound
    (12, 8, 16, 4),                                 # shallow near it
    (16, 8, 16, 0), (64, 8, 16, 0),                 # off: GPU-bound
    (0, 8, None, 0), (4, 0, None, 0)])              # degenerate
def test_pick_spec_k(batch, max_k, inflection, want):
    got = pick_spec_k(batch, max_k=max_k, inflection_batch=inflection)
    assert got == want == jx_spec.pick_spec_k(
        batch, max_k=max_k, inflection_batch=inflection)


# ------------------------------------------------------------ validation
def test_validate_draft_errors(tiny):
    jcfg, cfg, _, _ = tiny
    dcfg = default_draft_config(cfg)
    assert dcfg.name == jx_spec.default_draft_config(jcfg).name
    assert dcfg.n_layers == jx_spec.default_draft_config(jcfg).n_layers
    for bad, match, args in (
            ("spec_k", "spec_k", (cfg, dcfg, 0)),
            ("vocab", "vocab",
             (cfg, dcfg.replace(vocab_size=cfg.vocab_size + 1), 4)),
            ("depth", "not smaller", (cfg, cfg, 4))):
        with pytest.raises(ValueError, match=match) as err:
            validate_draft(*args)
        jargs = {"spec_k": (jcfg, jx_spec.default_draft_config(jcfg), 0),
                 "vocab": (jcfg, jx_spec.default_draft_config(jcfg).replace(
                     vocab_size=jcfg.vocab_size + 1), 4),
                 "depth": (jcfg, jcfg, 4)}[bad]
        with pytest.raises(ValueError) as jerr:
            jx_spec.validate_draft(*jargs)
        assert str(err.value) == str(jerr.value)


def test_engine_speculative_requires_jit_and_greedy(tiny):
    _, cfg, _, params = tiny
    kw = dict(max_batch=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="plan='jit'"):
        ServeEngine(cfg, params, speculative=True, plan="eager", **kw)
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(cfg, params, speculative=True, greedy=False, **kw)
    with pytest.raises(ValueError, match="speculative"):
        ServeEngine(cfg, params, draft_config=default_draft_config(cfg),
                    **kw)


def test_engine_rejects_non_truncation_draft_without_params(tiny):
    _, cfg, _, params = tiny
    bad = default_draft_config(cfg).replace(d_model=cfg.d_model * 2,
                                            head_dim=cfg.hd * 2)
    with pytest.raises(ValueError, match="draft_params"):
        ServeEngine(cfg, params, max_batch=2, max_len=32, device="cpu",
                    speculative=True, draft_config=bad)


def test_is_truncation_of_and_the_shared_draft_params(tiny):
    _, cfg, _, params = tiny
    dcfg = default_draft_config(cfg)
    assert is_truncation_of(dcfg, cfg)
    assert not is_truncation_of(cfg.replace(d_model=cfg.d_model * 2), cfg)
    dparams = draft_params_from_target(params, dcfg)
    assert len(dparams["blocks"]) == dcfg.n_layers < cfg.n_layers
    # the draft shares the target's tensors: nothing is copied
    assert dparams["embed"] is params["embed"]
    assert all(a is b for a, b in zip(dparams["blocks"], params["blocks"]))


@pytest.mark.parametrize("arch,fault", [
    ("rwkv6-3b", "recurrent"), ("bert-base-uncased", "causal")])
def test_speculation_refused_where_the_reference_breaks_greedy(arch, fault):
    """The reference speculates on RWKV-6 (its state advances through
    every verify token and cannot be rolled back) and on encoders (the
    verify attends non-causally inside its window); its speculative tokens
    then part from its greedy ones.  The port refuses both."""
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=fault) as err:
        ServeEngine(cfg, params, max_batch=2, max_len=32, device="cpu",
                    speculative=True)
    assert "speculative decoding" in str(err.value)
    assert "ROADMAP Queue C" in str(err.value)


# ------------------------------------------------ greedy byte-equivalence
@pytest.mark.parametrize("cache_kw", [{}, PAGED], ids=["contiguous",
                                                      "paged"])
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_matches_the_reference(tiny, seed, cache_kw):
    plain, _ = _reference(tiny, "plain", seed)
    key = "spec_paged" if cache_kw else "spec"
    jtoks, jcounts = _reference(tiny, key, seed, speculative=True, spec_k=4,
                                **cache_kw)
    toks, eng = _port(tiny, seed, speculative=True, spec_k=4, **cache_kw)
    assert toks == plain == jtoks
    assert {c: getattr(eng.stats, c) for c in COUNTERS} == jcounts
    assert eng.stats.spec_rounds > 0


@pytest.mark.parametrize("cache_kw", [{}, PAGED], ids=["contiguous",
                                                      "paged"])
def test_rejecting_draft_still_byte_identical(tiny, reject_draft, cache_kw):
    """Full-reject pressure: every round runs the correction path (and,
    paged, the block-table rollback of the over-grown verify window)."""
    (jdcfg, jdparams), (dcfg, dparams) = reject_draft
    plain, _ = _reference(tiny, "plain")
    key = "reject_paged" if cache_kw else "reject"
    jtoks, jcounts = _reference(
        tiny, key, speculative=True, spec_k=4, draft_config=jdcfg,
        draft_params=jdparams, **cache_kw)
    toks, eng = _port(tiny, speculative=True, spec_k=4, draft_config=dcfg,
                      draft_params=dparams, **cache_kw)
    assert toks == plain == jtoks
    assert {c: getattr(eng.stats, c) for c in COUNTERS} == jcounts
    assert eng.stats.accept_rate < 0.5
    assert eng.stats.corrections > 0


# -------------------------------------------------------- paged rollback
def test_block_pool_trim():
    """The rollback's allocator step, as the reference's."""
    for cls in (BlockPool, JxBlockPool):
        pool = cls(num_blocks=8, block_size=4)
        pool.alloc("r", 4)                   # covers 16 tokens
        assert pool.trim("r", 6) == [2, 3]   # only 2 blocks needed
        assert pool.owned("r") == [0, 1]
        assert pool.free_blocks == 6
        assert pool.trim("r", 6) == []       # idempotent
        assert pool.trim("missing", 1) == []


# ------------------------------------------------------------ counters
def test_counter_invariants(tiny):
    n = 3
    _, eng = _port(tiny, speculative=True, spec_k=3)
    st = eng.stats
    assert 0 < st.accepted <= st.proposed
    assert st.proposed <= 3 * st.spec_rounds * 4
    assert st.spec_emitted == st.accepted + st.corrections
    # each request's first token comes from prefill, the rest from rounds
    assert st.tokens_out == st.spec_emitted + n
    assert st.draft_dispatches >= st.spec_rounds          # >= 1 per round
    assert st.modeled_draft_launch_tax_s > 0
    assert 0 < st.steps_per_emitted_token < 1
    assert 0 < st.accept_rate <= 1
    snap = eng.registry.snapshot()
    assert (snap["speculative_draft_dispatches_total"]["series"][0]["value"]
            == st.draft_dispatches)
    # draft launches ride on the lead device's stream
    assert sum(eng.backend.device_dispatches.values()) >= st.draft_dispatches


def test_reset_clears_spec_state(tiny):
    _, cfg, _, params = tiny
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu",
                      speculative=True, spec_k=3)
    first = _toks(eng, Request, cfg.vocab_size, n=2)
    eng.reset()
    assert eng.stats.spec_rounds == 0
    assert not eng.draft_lengths.any()
    assert not any(t.any() for c in eng.draft_cache for t in c.values())
    assert _toks(eng, Request, cfg.vocab_size, n=2) == first


def test_depth_policy_disables_speculation_past_inflection(tiny):
    _, cfg, _, params = tiny
    ref = _toks(ServeEngine(cfg, params, max_batch=2, max_len=64,
                            device="cpu"), Request, cfg.vocab_size, n=2)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu",
                      speculative=True, spec_k=4, spec_inflection=1)
    assert _toks(eng, Request, cfg.vocab_size, n=2) == ref
    assert eng.stats.spec_rounds == 0
    assert eng.stats.proposed == 0


# ------------------------------------------------------------ serve CLI
def test_serve_cli_speculative():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng, done = serve.main(["--reduced", "--device", "cpu",
                                "--requests", "3", "--max-new", "6",
                                "--speculative", "--spec-k", "2",
                                "--draft-layers", "1"])
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rep["speculative"] is True and rep["spec_k"] == 2
    assert rep["draft"] == "smollm-360m-draft1sb"
    assert rep["spec_rounds"] > 0 and rep["draft_dispatches"] > 0
    assert rep["tokens_out"] == 3 * 6
    for key in ("proposed", "accepted", "corrections", "accept_rate",
                "steps_per_emitted_token", "modeled_draft_launch_tax_us"):
        assert key in rep
    for argv, match in ((["--speculative", "--plan", "eager"], "plan jit"),
                        (["--speculative", "--spec-k", "0"], "spec-k"),
                        (["--speculative", "--draft-layers", "9"],
                         "draft-layers")):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
            serve.main(["--reduced", "--device", "cpu", *argv])
        assert match in err.getvalue()
