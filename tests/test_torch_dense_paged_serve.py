"""The port's engine on the paper's workloads and the remaining dense
decoders, paged KV pool, against the reference, on reduced configs in f32
on the CPU.

* Each decoder (Llama-3.2-1B, GPT-2, InternLM2-20B, CodeQwen1.5-7B with a
  qkv bias drawn non-zero, Gemma-2-27B decoding past its reduced window of
  8) on a pool of 4-token pages: greedy tokens under ``plan="jit"`` (and
  ``plan="eager"`` for Llama and Gemma-2) equal the JAX
  ``ServeEngine(cache="paged", plan="jit")``'s; CodeQwen and Gemma-2 also
  on int8 pages, Gemma-2 also with chunked prefill.
* The encoders (BERT, XLM-R): a paged prefill holds only prompt tokens,
  so the port's tokens, the JAX paged engine's and the reference's
  unpadded incremental ``forward`` all agree.
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
from repro.models import init_params as jx_init_params
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
    """Ragged prompts through two slots; the longest decodes to position
    19, past Gemma-2's reduced window."""
    rng = np.random.default_rng(7)
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(plens, budgets))]


def _tokens(done):
    return [(r.rid, r.status, r.generated) for r in done]


# (config, page dtype, prefill chunk, plans): every decoder on bf16 pages
# under jit, Llama and Gemma-2 under eager too; the new attention options
# (CodeQwen's bias, Gemma-2's window and softcap) on int8 pages and
# Gemma-2's across chunked prefill
CASES = [(name, "bf16", None, ("jit", "eager") if name in (
    "llama-3.2-1b", "gemma2-27b") else ("jit",)) for name in DECODERS] + [
    ("codeqwen1.5-7b", "int8", None, ("jit",)),
    ("gemma2-27b", "int8", None, ("jit",)),
    ("gemma2-27b", "bf16", 4, ("jit",))]


@pytest.mark.parametrize("name,kv,chunk,plans", CASES,
                         ids=[f"{c[0]}-{c[1]}-chunk{c[2]}" for c in CASES])
def test_decoder_tokens_match_the_reference_paged_engine(name, kv, chunk,
                                                         plans):
    jcfg, cfg, jparams, params = model(name)
    opts = dict(max_batch=2, max_len=MAX_LEN, cache="paged", block_size=4,
                kv_dtype=kv, prefill_chunk=chunk)
    jeng = JxServeEngine(jcfg, jparams, plan="jit", platform="Intel+H100",
                         **opts)
    want = _tokens(jeng.run(_requests(JxRequest, cfg.vocab_size)))
    assert all(status == "done" for _, status, _ in want)
    for plan in plans:
        eng = ServeEngine(cfg, params, plan=plan, device="cpu", **opts)
        assert _tokens(eng.run(_requests(Request, cfg.vocab_size))) == \
            want, plan
        assert eng.stats.prefill_chunks == jeng.stats.prefill_chunks


@pytest.mark.parametrize("name", ENCODERS)
def test_encoder_paged_tokens_match_the_reference_paged_engine(name):
    jcfg, cfg, jparams, params = model(name)
    opts = dict(max_batch=2, max_len=MAX_LEN, cache="paged", block_size=4)
    plens, budgets = (5, 8, 11, 16), (4, 4, 4, 4)
    jeng = JxServeEngine(jcfg, jparams, plan="jit", platform="Intel+H100",
                         **opts)
    want = _tokens(jeng.run(_requests(JxRequest, cfg.vocab_size, plens,
                                      budgets)))
    eng = ServeEngine(cfg, params, plan="jit", device="cpu", **opts)
    assert _tokens(eng.run(_requests(Request, cfg.vocab_size, plens,
                                     budgets))) == want
