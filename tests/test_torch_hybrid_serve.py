"""The port's serving engine on the reduced Jamba hybrid (Mamba layers
around one attention slot, MoE in the odd slots) against the JAX package,
in f32 on the CPU.

At prompt lengths that fill their power-of-two bucket (8, 16) the greedy
tokens are byte-identical to the JAX ``ServeEngine``'s.  At other lengths
the JAX engine runs its pad tokens through the Mamba state, so the port
(which prefills exactly the prompt, as for RWKV-6) is held against the
reference's unpadded incremental ``forward``; a reused slot starts from a
zeroed state.  The paged cache and speculation refuse the stack, as the
reference's paged cache does.  Launch plans serve the jit engine's tokens,
the fused plan through the norm windows of ``models.norm_launches``.
"""
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
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.models import norm_launches

torch.set_num_threads(2)
ARCH = "jamba-1.5-large-398b"
MAX_LEN = 48


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _requests(cls, plens, vocab, seed, budget=5):
    rng = np.random.default_rng(seed)
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=budget) for i, n in enumerate(plens)]


def test_bucket_sized_prompts_match_the_reference_engine(setup):
    jcfg, cfg, jparams, params = setup
    plens = (8, 16, 8, 16)
    kw = dict(max_batch=2, max_len=MAX_LEN)
    jeng = JxServeEngine(jcfg, jparams, plan="jit", **kw)
    jdone = jeng.run(_requests(JxRequest, plens, cfg.vocab_size, 2))
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    done = eng.run(_requests(Request, plens, cfg.vocab_size, 2))
    assert [(r.rid, r.generated) for r in done] == \
        [(r.rid, r.generated) for r in jdone]
    for field in ("prefills", "decode_steps", "tokens_out"):
        assert getattr(eng.stats, field) == getattr(jeng.stats, field)


def _incremental(jparams, jcfg, prompt, n_new):
    """Greedy tokens of the reference's forward, fed the prompt unpadded
    and then one token at a time (``tests/test_system.py``)."""
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


def test_other_lengths_match_the_unpadded_incremental_forward(setup):
    """One slot, two requests: the second reuses the first's slot and
    starts from a zeroed Mamba state."""
    jcfg, cfg, jparams, params = setup
    eng = ServeEngine(cfg, params, max_batch=1, max_len=MAX_LEN,
                      device="cpu")
    done = eng.run(_requests(Request, (5, 11), cfg.vocab_size, 3, budget=4))
    assert eng.stats.prefills == 2
    for r in done:
        assert r.generated == _incremental(jparams, jcfg, r.prompt, 4), r.rid


def test_refuses_the_paged_cache_and_speculation(setup):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="pure-attention"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                    cache="paged", block_size=4)
    with pytest.raises(ValueError, match="recurrent"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                    speculative=True)


def test_fused_plan_serves_jit_tokens(setup):
    """Each traced call (a prefill of its exact length, a decode step)
    finds a ``rmsnorm_matmul`` a superblock, a ``residual_rmsnorm`` at
    every other norm of a layer, and a ``rmsnorm_matmul`` at the final norm
    with the untied unembed's product."""
    _, cfg, _, params = setup
    kw = dict(max_batch=2, max_len=MAX_LEN, device="cpu")
    jit = ServeEngine(cfg, params, **kw).run(
        _requests(Request, (8, 11), cfg.vocab_size, 5))
    eng = ServeEngine(cfg, params, plan="fused", **kw)
    done = eng.run(_requests(Request, (8, 11), cfg.vocab_size, 5))
    assert [r.generated for r in done] == [r.generated for r in jit]
    want = norm_launches(cfg)
    fns = list(eng.backend._planned_fns.values())
    assert len(fns) == 3                 # prefills of 8 and 11, the decode
    for pf in fns:
        hits = {n: pf.rule_names.count(n) for n in set(pf.rule_names)}
        assert hits == want, hits
