"""Speculative decoding on Gemma-2 against the reference, on the CPU.

Reduced Gemma-2-27B at 4 layers (local and global layers in turn, the
window cut to 8 so that it bites within the requests, soft-capped scores;
f32, the reference's weights bridged bit for bit): the port's speculative
tokens equal the JAX engine's plain greedy and speculative tokens, on the
contiguous cache and the paged pool, seeds 0 and 1, with the JAX
speculative engine's counters.  The verify's queries each keep their own
window (``kernels.decode_attention_mq``).
"""
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

torch.set_num_threads(2)
COUNTERS = ("spec_rounds", "proposed", "accepted", "corrections",
            "draft_dispatches", "tokens_out", "decode_steps")
KW = dict(max_batch=4, max_len=64)


@pytest.fixture(scope="module")
def gemma2():
    jcfg = jx_reduced(jx_get_config("gemma2-27b"), n_layers=4)
    cfg = reduced(get_config("gemma2-27b"), n_layers=4)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _requests(cls, vocab, seed, n=3, new=10):
    rng = np.random.default_rng(seed)
    return [cls(i, prompt=[int(t) for t in rng.integers(1, vocab, 5 + i)],
                max_new_tokens=new) for i in range(n)]


def _run(eng, cls, vocab, seed):
    return {r.rid: list(r.generated)
            for r in eng.run(_requests(cls, vocab, seed))}


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_matches_the_reference(gemma2, seed):
    jcfg, cfg, jparams, params = gemma2
    assert cfg.sliding_window == 8 and cfg.attn_softcap > 0
    plain = _run(JxServeEngine(jcfg, jparams, **KW), JxRequest,
                 jcfg.vocab_size, seed)
    for cache_kw in ({}, dict(cache="paged", block_size=4, num_blocks=64)):
        jeng = JxServeEngine(jcfg, jparams, speculative=True, spec_k=4,
                             **KW, **cache_kw)
        jtoks = _run(jeng, JxRequest, jcfg.vocab_size, seed)
        eng = ServeEngine(cfg, params, speculative=True, spec_k=4,
                          device="cpu", **KW, **cache_kw)
        toks = _run(eng, Request, cfg.vocab_size, seed)
        assert toks == plain == jtoks, cache_kw
        assert {c: getattr(eng.stats, c) for c in COUNTERS} == {
            c: getattr(jeng.stats, c) for c in COUNTERS}, cache_kw
        assert eng.stats.spec_rounds > 0
