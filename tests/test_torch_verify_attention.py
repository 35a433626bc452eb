"""Multi-token decode (the speculative verify) against the reference, on the
CPU.

* ``forward`` with S = k+1 tokens a row at ragged per-row ``lengths``
  against ``repro.models.forward(..., lengths=)`` on reduced SmolLM in f32
  (logits within 1e-4), on the contiguous cache, the paged pool and the
  int8 pool, with a row whose window runs past the cache or its table (the
  writes there drop in both), the kernels it calls counted;
* the draft's catch-up step: explicit ``positions`` with padding columns
  at ``max_len``, whose writes drop and whose logits are not read, against
  the reference with the same positions;
* the multi-query plain versions (contiguous, paged, int8 paged) against
  the reference's ``mha`` with the verify's masks, windows and softcaps
  included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.layers.attention import mha as jx_mha
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro.models import make_paged_cache as jx_make_paged_cache
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.inference.kv_quant import quantize_kv
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_mq_ref, paged_decode_attention_mq_ref,
    paged_decode_attention_quant_mq_ref)
from repro_torch.models import forward, make_cache, make_paged_cache

torch.set_num_threads(2)
LOGIT_ATOL = 1e-4
TOL = dict(atol=2e-5, rtol=2e-5)


def J_(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _spy(monkeypatch):
    calls = {name: 0 for name in kernels.WRAPPERS}
    for name, fn in kernels.WRAPPERS.items():
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_contiguous_verify_matches_the_reference(setup, monkeypatch):
    jcfg, cfg, jparams, params = setup
    b, t, s = 3, 16, 5
    jcache = jx_make_cache(jcfg, b, t, src_len=1, dtype=jcfg.cdtype)
    cache = make_cache(cfg, b, t, device="cpu")
    prompt = _tokens(0, (b, 6), cfg.vocab_size)
    jl, _, jcache = jx_forward(jparams, J_(prompt), jcfg, cache=jcache)
    tl, _ = forward(params, prompt, cfg, cache=cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    calls = _spy(monkeypatch)
    n = cfg.n_layers
    # ragged rows; row 1's window runs past the cache (positions 13..17)
    for step, lengths in enumerate(([6, 4, 5], [8, 13, 9])):
        lengths = np.asarray(lengths, np.int32)
        tok = _tokens(step + 1, (b, s), cfg.vocab_size)
        jl, _, jcache = jx_forward(jparams, J_(tok), jcfg, cache=jcache,
                                   lengths=J_(lengths))
        for name in calls:
            calls[name] = 0
        tl, _ = forward(params, tok, cfg, cache=cache, lengths=lengths)
        assert calls == {**{k: 0 for k in calls}, "rmsnorm_matmul": n,
                         "residual_rmsnorm": n + 1,
                         "decode_attention_mq": n}
        assert tl.shape == (b, s, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    for i in range(n):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache[i][name].numpy(),
                np.asarray(jcache["slot0"]["self"][name][i]),
                atol=LOGIT_ATOL)


def test_catch_up_step_with_padding_columns(setup):
    """Right-aligned width-2 draft step: a row one token behind feeds two
    tokens; a caught-up row pads its first column with position T; a free
    row pads both.  The padding writes drop, and the last column's logits
    (the only ones read) equal the reference's."""
    jcfg, cfg, jparams, params = setup
    b, t = 3, 16
    jcache = jx_make_cache(jcfg, b, t, src_len=1, dtype=jcfg.cdtype)
    cache = make_cache(cfg, b, t, device="cpu")
    prompt = _tokens(3, (b, 7), cfg.vocab_size)
    _, _, jcache = jx_forward(jparams, J_(prompt), jcfg, cache=jcache)
    forward(params, prompt, cfg, cache=cache)
    before = [{k: v.clone() for k, v in c.items()} for c in cache]
    pos = np.asarray([[t, 7], [6, 7], [t, t]], np.int32)
    lengths = np.asarray([7, 6, 0], np.int32)
    tok = _tokens(4, (b, 2), cfg.vocab_size)
    jl, _, jcache = jx_forward(jparams, J_(tok), jcfg, cache=jcache,
                               positions=J_(pos), lengths=J_(lengths))
    tl, _ = forward(params, tok, cfg, cache=cache, positions=pos,
                    lengths=lengths)
    np.testing.assert_allclose(tl[:, -1].numpy(), np.asarray(jl[:, -1]),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]),
                               atol=LOGIT_ATOL)
    for i, c in enumerate(cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                c[name].numpy(),
                np.asarray(jcache["slot0"]["self"][name][i]),
                atol=LOGIT_ATOL)
            # only row 0 position 7 and row 1 positions 6, 7 changed
            changed = (c[name] != before[i][name]).any(-1).any(-1)
            want = torch.zeros_like(changed)
            want[0, 7] = want[1, 6] = want[1, 7] = True
            assert torch.equal(changed, want)
    # one column: the positions stand for the lengths (the later draft steps)
    pos1 = np.asarray([[8], [8], [t]], np.int32)
    jl, _, jcache = jx_forward(jparams, J_(tok[:, :1]), jcfg, cache=jcache,
                               positions=J_(pos1), lengths=J_(pos1[:, 0]))
    tl, _ = forward(params, tok[:, :1], cfg, cache=cache, positions=pos1,
                    lengths=pos1[:, 0])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_verify_matches_the_reference(setup, kv_dtype, monkeypatch):
    jcfg, cfg, jparams, params = setup
    b, max_len, bs, s = 2, 32, 8, 4
    pool = b * (max_len // bs)
    sentinel = pool + 5
    prompts = [[5, 9, 2, 7, 1], [3, 8, 4, 4, 6, 2, 9, 1, 5]]
    jcache = jx_make_paged_cache(jcfg, pool, bs, dtype=jcfg.cdtype,
                                 kv_dtype=kv_dtype)
    cache = make_paged_cache(cfg, pool, bs, kv_dtype=kv_dtype, device="cpu")
    tables = np.full((b, max_len // bs), sentinel, np.int32)
    free = list(np.random.default_rng(0).permutation(pool))
    for i, p in enumerate(prompts):
        tables[i, :-(-len(p) // bs)] = [free.pop(0)
                                        for _ in range(-(-len(p) // bs))]
        _, _, jcache = jx_forward(jparams, J_([p]), jcfg, cache=jcache,
                                  cache_index=jnp.asarray(0, jnp.int32),
                                  block_tables=J_(tables[i:i + 1]))
        forward(params, np.asarray([p]), cfg, cache=cache, cache_index=0,
                block_tables=tables[i:i + 1])
    calls = _spy(monkeypatch)
    n = cfg.n_layers
    paged = "paged_decode_attention" + ("_quant" if kv_dtype == "int8"
                                        else "") + "_mq"
    lengths = np.array([len(p) for p in prompts], np.int32)
    for step in range(2):
        tok = _tokens(10 + step, (b, s), cfg.vocab_size)
        # grow row 0's table over its window; row 1's only up to its first
        # verify position, so its later positions drop in the second step
        for i in range(b):
            need = lengths[i] + (s if i == 0 or step == 0 else 1)
            while (tables[i] != sentinel).sum() * bs < need:
                tables[i, (tables[i] != sentinel).sum()] = free.pop(0)
        jl, _, jcache = jx_forward(jparams, J_(tok), jcfg, cache=jcache,
                                   lengths=J_(lengths),
                                   block_tables=J_(tables))
        for name in calls:
            calls[name] = 0
        tl, _ = forward(params, tok, cfg, cache=cache, lengths=lengths,
                        block_tables=tables)
        assert calls == {**{k: 0 for k in calls}, "rmsnorm_matmul": n,
                         "residual_rmsnorm": n + 1, paged: n}
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        lengths += s - 1
    names = (("k_pages", "v_pages", "k_scale", "v_scale")
             if kv_dtype == "int8" else ("k_pages", "v_pages"))
    for i in range(n):
        for name in names:
            np.testing.assert_allclose(
                cache[i][name].numpy().astype(np.float32),
                np.asarray(jcache["slot0"]["self"][name][i]).astype(
                    np.float32), atol=LOGIT_ATOL)


def _masked_mha(q, k, v, kv_lens, scale, window, cap):
    """The reference's verify attention over a (B,T,HKV,hd) view: query j
    at kv_lens - S + j, keys up to it (and within the window)."""
    b, s = q.shape[:2]
    t = k.shape[1]
    pos = kv_lens[:, None] - s + np.arange(s)[None]
    kv_pos = np.broadcast_to(np.arange(t), (b, t))
    out = jx_mha(J_(q), J_(k), J_(v), scale=scale, causal=True,
                 window=window, cap=cap, q_positions=J_(pos),
                 kv_positions=J_(kv_pos),
                 kv_valid=J_(kv_pos <= pos[:, -1:]))
    return np.asarray(out)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 30.0),
                                        (4, 50.0)])
@pytest.mark.parametrize("s", [2, 5])
def test_multi_query_plain_versions_match_the_reference(s, window, cap):
    b, hq, hkv, t, hd, bs = 3, 4, 2, 24, 16, 8
    scale = hd ** -0.5
    q = _rand(0, (b, s, hq, hd))
    k = _rand(1, (b, t, hkv, hd))
    v = _rand(2, (b, t, hkv, hd))
    kv_lens = np.array([11, s + 1, t + 2], np.int32)   # row 2 past T
    want = _masked_mha(q, k, v, kv_lens, scale, window, cap)
    opts = dict(scale=scale, window=window, softcap=cap)
    lens = torch.from_numpy(kv_lens)
    kt = torch.from_numpy(k).transpose(1, 2)
    vt = torch.from_numpy(v).transpose(1, 2)
    got = decode_attention_mq_ref(torch.from_numpy(q), kt, vt, lens, **opts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper (CPU: the plain version through the custom op)
    got = kernels.decode_attention_mq(torch.from_numpy(q), kt, vt, lens,
                                      **opts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same logical KV in permuted pages, sentinel entries past the rows
    nb = t // bs
    n_pages = b * nb + 2
    perm = np.random.default_rng(3).permutation(n_pages)
    table = perm[:b * nb].reshape(b, nb).astype(np.int32)
    kp = np.zeros((n_pages, bs, hkv, hd), np.float32)
    vp = np.zeros_like(kp)
    for row in range(b):
        for i in range(nb):
            kp[table[row, i]] = k[row, i * bs:(i + 1) * bs]
            vp[table[row, i]] = v[row, i * bs:(i + 1) * bs]
    bt = torch.from_numpy(table)
    got = kernels.paged_decode_attention_mq(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), bt,
        lens, **opts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        paged_decode_attention_mq_ref(torch.from_numpy(q),
                                      torch.from_numpy(kp),
                                      torch.from_numpy(vp), bt, lens,
                                      **opts).numpy(), want, **TOL)
    # int8 pages: the reference attends the dequantized logical KV
    kq, ks = quantize_kv(torch.from_numpy(kp))
    vq, vs = quantize_kv(torch.from_numpy(vp))
    kd = (kq.float() * ks[..., None]).numpy()
    vd = (vq.float() * vs[..., None]).numpy()
    logical_k = kd[table].reshape(b, t, hkv, hd)
    logical_v = vd[table].reshape(b, t, hkv, hd)
    want_q = _masked_mha(q, logical_k, logical_v, kv_lens, scale, window,
                         cap)
    got = kernels.paged_decode_attention_quant_mq(
        torch.from_numpy(q), kq, vq, ks, vs, bt, lens, **opts)
    np.testing.assert_allclose(got.numpy(), want_q, **TOL)
    np.testing.assert_allclose(
        paged_decode_attention_quant_mq_ref(
            torch.from_numpy(q), kq, vq, ks, vs, bt, lens, **opts).numpy(),
        want_q, **TOL)
