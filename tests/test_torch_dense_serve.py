"""The port's engine on the paper's workloads and the remaining dense
decoders, contiguous cache, against the reference, on reduced configs in
f32 on the CPU.

* Each decoder (Llama-3.2-1B, GPT-2, InternLM2-20B, CodeQwen1.5-7B with a
  qkv bias drawn non-zero, Gemma-2-27B decoding past its reduced window of
  8): greedy tokens under ``plan="jit"`` and ``plan="eager"`` equal the
  JAX ``ServeEngine(plan="jit")``'s on the same bridged weights.
* The encoders (BERT, XLM-R): the port prefills exactly the prompt's
  tokens, no bucket pad, so its tokens equal the reference's unpadded
  incremental ``forward`` (the prompt in one call, then one token a call).
  The JAX engine pads each prompt to its power-of-two bucket and its
  non-causal prefill lets the prompt attend the pads: its tokens part from
  that forward at prompt lengths 5 and 11 and agree at 8 and 16 (ROADMAP
  Queue C).
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

torch.set_num_threads(2)
MAX_LEN = 32
DECODERS = ("llama-3.2-1b", "gpt2", "internlm2-20b", "codeqwen1.5-7b",
            "gemma2-27b")
ENCODERS = ("bert-base-uncased", "xlm-roberta-base")
_MODELS: dict = {}


def model(name):
    """(jax cfg, port cfg, jax params, port params) of reduced ``name``;
    a qkv bias is drawn non-zero in the reference's params first."""
    if name not in _MODELS:
        jcfg = jx_reduced(jx_get_config(name))
        cfg = reduced(get_config(name))
        tree = jax.tree.map(np.asarray,
                            jx_init_params(jax.random.PRNGKey(0), jcfg))
        rng = np.random.default_rng(5)
        for slot in tree["blocks"].values():
            for b in ("bq", "bk", "bv"):
                if b in slot["mixer"]:
                    slot["mixer"][b] = rng.standard_normal(
                        slot["mixer"][b].shape).astype(np.float32) * 0.5
        params = bridge.params_from_jax(tree, cfg, device="cpu")
        _MODELS[name] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree), params)
    return _MODELS[name]


def _requests(cls, vocab, plens=(5, 12, 9, 3), budgets=(6, 8, 4, 10)):
    """Ragged prompts (buckets 8 and 16) through two slots; the longest
    decodes to position 19, past Gemma-2's reduced window."""
    rng = np.random.default_rng(7)
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(plens, budgets))]


def _tokens(done):
    return [(r.rid, r.status, r.generated) for r in done]


@pytest.mark.parametrize("name", DECODERS)
def test_decoder_tokens_match_the_reference_engine(name):
    jcfg, cfg, jparams, params = model(name)
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit")
    want = _tokens(jeng.run(_requests(JxRequest, cfg.vocab_size)))
    assert all(status == "done" for _, status, _ in want)
    for plan in ("jit", "eager"):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                          plan=plan, device="cpu")
        assert _tokens(eng.run(_requests(Request, cfg.vocab_size))) == \
            want, plan
        assert eng.stats.decode_steps == jeng.stats.decode_steps


ENC_PLENS, ENC_BUDGETS = (5, 8, 11, 16), (4, 4, 4, 4)


def _incremental(jcfg, jparams, prompt, n):
    """Greedy tokens of the reference's unpadded incremental forward."""
    cache = jx_make_cache(jcfg, 1, MAX_LEN, src_len=1, dtype=jcfg.cdtype)
    logits, _, cache = jx_forward(jparams, jnp.asarray([prompt]), jcfg,
                                  cache=cache,
                                  cache_index=jnp.zeros((), jnp.int32))
    out = []
    for i in range(n):
        out.append(int(np.argmax(np.asarray(logits[0, -1]))))
        logits, _, cache = jx_forward(
            jparams, jnp.asarray([[out[-1]]]), jcfg, cache=cache,
            lengths=jnp.asarray([len(prompt) + i], jnp.int32))
    return out


@pytest.mark.parametrize("name", ENCODERS)
def test_encoder_tokens_match_the_unpadded_incremental_forward(name):
    jcfg, cfg, jparams, params = model(name)
    reqs = _requests(Request, cfg.vocab_size, ENC_PLENS, ENC_BUDGETS)
    want = [_incremental(jcfg, jparams, r.prompt, r.max_new_tokens)
            for r in reqs]
    for plan in ("jit", "eager"):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                          plan=plan, device="cpu")
        done = eng.run(_requests(Request, cfg.vocab_size, ENC_PLENS,
                                 ENC_BUDGETS))
        assert [r.generated for r in done] == want, plan
    # the reference's engine pads to the bucket: the prompt sees the pads
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit")
    jdone = jeng.run(_requests(JxRequest, cfg.vocab_size, ENC_PLENS,
                               ENC_BUDGETS))
    parted = {len(r.prompt) for r, w in zip(jdone, want)
              if r.generated != w}
    assert parted == {5, 11}
