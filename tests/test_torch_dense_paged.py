"""The paper's workloads and the remaining dense decoders on the paged
KV pool, against the reference, on reduced configs in f32 on the CPU.

For each of the seven new configs (``test_torch_dense_models.py``; a
CodeQwen qkv bias drawn non-zero) in bf16 pages, and CodeQwen and Gemma-2
in int8 pages too: each row's
prompt prefilled in chunks through a block table over permuted pages, then
batched decode steps past position 8 (Gemma-2's reduced window), with
logits within 1e-4 of ``repro.models.forward(..., block_tables=...)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_paged_cache as jx_make_paged_cache
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.models import forward, make_paged_cache

torch.set_num_threads(2)
ATOL = 1e-4
T = 32
NEW = ("llama-3.2-1b", "gpt2", "internlm2-20b", "codeqwen1.5-7b",
       "gemma2-27b", "bert-base-uncased", "xlm-roberta-base")
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


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# int8 pages for the two configs whose attention options reach the int8
# kernel's plain version (the qkv bias; the window and softcap)
CASES = [(name, "bf16") for name in NEW] + [
    ("codeqwen1.5-7b", "int8"), ("gemma2-27b", "int8")]


@pytest.mark.parametrize("name,kv_dtype", CASES)
def test_paged_prefill_then_decode(name, kv_dtype):
    """Each row's prompt in chunks of 5 through a block table over
    permuted pages of 4 tokens, then batched decode steps to length 11."""
    jcfg, cfg, jparams, params = model(name)
    b, bs = 2, 4
    nb = T // bs
    pool = b * nb
    jcache = jx_make_paged_cache(jcfg, pool, bs, dtype=jcfg.cdtype,
                                 kv_dtype=kv_dtype)
    cache = make_paged_cache(cfg, pool, bs, kv_dtype=kv_dtype, device="cpu")
    tables = np.full((b, nb), pool, np.int32)
    tables[:] = np.random.default_rng(2).permutation(pool).reshape(b, nb)
    prompts = [_tokens(3, 9, cfg.vocab_size), _tokens(4, 6, cfg.vocab_size)]
    for i, p in enumerate(prompts):
        for t0 in range(0, len(p), 5):
            chunk = p[None, t0:t0 + 5]
            jl, _, jcache = jx_forward(
                jparams, jnp.asarray(chunk), jcfg, cache=jcache,
                cache_index=jnp.asarray(t0, jnp.int32),
                block_tables=jnp.asarray(tables[i:i + 1]))
            tl, cache = forward(params, torch.from_numpy(chunk), cfg,
                                cache=cache, cache_index=t0,
                                block_tables=tables[i:i + 1])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL)
    lens = np.array([len(p) for p in prompts], np.int32)
    for step in range(3):
        tok = _tokens(20 + step, (b, 1), cfg.vocab_size)
        jl, _, jcache = jx_forward(jparams, jnp.asarray(tok), jcfg,
                                   cache=jcache, lengths=jnp.asarray(lens),
                                   block_tables=jnp.asarray(tables))
        tl, cache = forward(params, torch.from_numpy(tok), cfg, cache=cache,
                            lengths=lens, block_tables=tables)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {step}")
        lens = lens + 1
