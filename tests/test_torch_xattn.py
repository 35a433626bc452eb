"""The port's cross-attention stacks against the JAX package, in f32 on
the CPU: reduced Llama-3.2-Vision-11B (an ``xattn`` layer every fifth
layer, over image-patch states) and reduced SeamlessM4T-medium (an
encoder, and a decoder whose every layer cross-attends to it).

Reference weights go through ``repro_torch.bridge`` (bit for bit).  Every
``xgate`` is set to 0.5 in the reference's numpy arrays before they cross:
the reference initialises it to 0, and ``tanh(0)`` zeroes every vision
cross layer, which would make each comparison of the image path vacuous.
The cross path of ``attention_fwd`` and ``init_cross_cache`` agree within
2e-5; ``forward`` with ``frontend_embeds`` and with ``encoder_tokens``
within 1e-4 of ``repro.models.forward``, as a full forward and as a
prefill that writes the cross caches followed by decode steps that read
them (the port's counterpart of ``test_decode_matches_full_forward``); and
the forward launches the fused norm kernels at the reference's fused-plan
windows.
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
from repro.layers import attention as jx_attn
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro.runtime.rules import find_matches
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.layers import attention as attn
from repro_torch.models import (attention_launches, forward, init_params,
                                make_cache, norm_launches)

torch.set_num_threads(2)
VISION, SEAMLESS = "llama-3.2-vision-11b", "seamless-m4t-medium"
NAMES = (VISION, SEAMLESS)
TOL = 2e-5
ATOL = 1e-4
GATE = 0.5
T = 24
_MODELS: dict = {}


def _model(name):
    """(jax cfg, port cfg, reference params with xgate = GATE, port
    params), one per module."""
    if name not in _MODELS:
        jcfg, cfg = jx_reduced(jx_get_config(name)), reduced(get_config(name))
        tree = jax.tree.map(np.asarray,
                            jx_init_params(jax.random.PRNGKey(0), jcfg))
        for slot in tree["blocks"].values():
            if "xgate" in slot:
                slot["xgate"] = np.full_like(slot["xgate"], GATE)
        params = bridge.params_from_jax(tree, cfg, device="cpu")
        jparams = jax.tree.map(jnp.asarray, tree)
        _MODELS[name] = (jcfg, cfg, jparams, params)
    return _MODELS[name]


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _inputs(cfg, seed, b):
    """The stub frontend's states: frame embeddings for the encoder, or
    patch embeddings for the vision stack, (B, n_frontend_tokens, D)."""
    src = _x(seed, (b, cfg.n_frontend_tokens, cfg.d_model))
    key = "encoder_tokens" if cfg.n_encoder_layers else "frontend_embeds"
    return ({key: jnp.asarray(src)}, {key: torch.from_numpy(src)})


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_the_reference(name):
    for mk_j, mk_t in ((lambda c: c, lambda c: c), (jx_reduced, reduced)):
        jc, tc = mk_j(jx_get_config(name)), mk_t(get_config(name))
        for f in tc.__dataclass_fields__:
            assert getattr(jc, f) == getattr(tc, f), f
        assert jc.hd == tc.hd and jc.n_superblocks == tc.n_superblocks


@pytest.mark.parametrize("name", NAMES)
def test_bridge_carries_the_cross_leaves(name):
    """Every reference leaf reaches the port bit for bit: the cross
    layers' mixers and gates, the decoder's ``norm_x``/``xattn`` and the
    encoder's layers (unstacked) and ``enc_norm``; the port's own init
    builds the same tree."""
    _, cfg, jparams, params = _model(name)
    jblocks = jparams["blocks"]
    period = len(cfg.block_pattern)
    for i, blk in enumerate(params["blocks"]):
        ref = jblocks[f"slot{i % period}"]
        assert set(blk) == set(ref)
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        for path, leaf in flat:
            t = blk
            for p in path:
                t = t[p.key]
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(leaf)[i // period])
    if cfg.n_encoder_layers:
        assert len(params["enc_blocks"]) == cfg.n_encoder_layers
        for i, blk in enumerate(params["enc_blocks"]):
            np.testing.assert_array_equal(
                blk["mixer"]["wk"].numpy(),
                np.asarray(jparams["enc_blocks"]["slot0"]["mixer"]["wk"])[i])
            assert "xattn" not in blk and "norm_x" not in blk
        np.testing.assert_array_equal(params["enc_norm"]["scale"].numpy(),
                                      np.asarray(jparams["enc_norm"]["scale"]))
    else:
        gates = [blk["xgate"] for blk in params["blocks"] if "xgate" in blk]
        assert len(gates) == cfg.n_superblocks
        assert all(g.shape == () and float(g) == GATE for g in gates)
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), own)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), params)


def test_cross_attention_matches_the_reference():
    """The cross path of ``attention_fwd`` (no RoPE, no mask, over all T
    source positions) with K/V from ``cross_kv`` (no cache, and written
    into one), then from the cache at one query (decode) and at three
    (a verify); and ``init_cross_cache``."""
    jcfg, cfg = jx_reduced(jx_get_config(VISION)), reduced(get_config(VISION))
    p = jx_attn.attention_init(jax.random.PRNGKey(4), jcfg, cross=True)
    assert set(p) == {"wq", "wk", "wv", "wo"}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    b, s, t = 2, 5, 7
    h = _x(1, (b, s, cfg.d_model))
    src = _x(2, (b, t, cfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    jo, _ = jx_attn.attention_fwd(p, jnp.asarray(h), jcfg, positions=pos,
                                  is_cross=True, cross_kv=jnp.asarray(src))
    to = attn.cross_attention_fwd(tp, torch.from_numpy(h), None, cfg,
                                  cross_kv=torch.from_numpy(src))
    _close(to, jo)
    jc = jx_attn.init_cross_cache(p, jcfg, jnp.asarray(src))
    tc = attn.init_cross_cache(tp, cfg, torch.from_numpy(src))
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    cache = attn.make_cross_cache(cfg, b, t, torch.float32, "cpu")
    jcache = jx_attn.make_self_cache(jcfg, b, t, jnp.float32)
    jo, jcache = jx_attn.attention_fwd(
        p, jnp.asarray(h), jcfg, positions=pos, is_cross=True,
        cross_kv=jnp.asarray(src), cache=jcache)
    to = attn.cross_attention_fwd(tp, torch.from_numpy(h), None, cfg,
                                  cache=cache, cross_kv=torch.from_numpy(src))
    _close(to, jo)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    for n, decode in ((1, True), (3, False)):
        q = _x(3 + n, (b, n, cfg.d_model))
        jo, _ = jx_attn.attention_fwd(
            p, jnp.asarray(q), jcfg, positions=pos[:, :n] + 9, is_cross=True,
            cache=jcache)
        to = attn.cross_attention_fwd(tp, torch.from_numpy(q), None, cfg,
                                      cache=cache, decode=decode)
        _close(to, jo)


@pytest.mark.parametrize("name", NAMES)
def test_forward_with_cross_inputs_matches_the_reference(name):
    jcfg, cfg, jparams, params = _model(name)
    jin, tin = _inputs(cfg, 5, 2)
    toks = _tokens(6, (2, 9), cfg.vocab_size)
    jl = jx_forward(jparams, jnp.asarray(toks), jcfg, **jin)[0]
    tl, _ = forward(params, torch.from_numpy(toks), cfg, **tin)
    _close(tl, jl, ATOL)
    # the gate and the cross inputs move the logits (the check is not
    # vacuous)
    other = {k: torch.zeros_like(v) for k, v in tin.items()}
    tz, _ = forward(params, torch.from_numpy(toks), cfg, **other)
    assert float((tz - tl).abs().max()) > 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_full_forward(name):
    """A prefill with the cross inputs writes the cross caches (equal to
    the reference's), and later calls read them: a decode step at the
    prompt's end (``cache_index``, as the reference's test), then
    per-row decode steps (``lengths``), each within ATOL of the reference's
    logits and the first of the full forward's last position."""
    jcfg, cfg, jparams, params = _model(name)
    b, s = 2, 17
    src = cfg.n_frontend_tokens
    jin, tin = _inputs(cfg, 7, b)
    toks = _tokens(8, (b, s), cfg.vocab_size)
    full, _ = forward(params, torch.from_numpy(toks), cfg, **tin)
    jfull = jx_forward(jparams, jnp.asarray(toks), jcfg, **jin)[0]
    _close(full, jfull, ATOL)
    cache = make_cache(cfg, b, T, src_len=src, device="cpu")
    jcache = jx_make_cache(jcfg, b, T, src_len=src)
    tl, cache = forward(params, torch.from_numpy(toks[:, :s - 1]), cfg,
                        cache=cache, **tin)
    jl, _, jcache = jx_forward(jparams, jnp.asarray(toks[:, :s - 1]), jcfg,
                               cache=jcache,
                               cache_index=jnp.zeros((), jnp.int32), **jin)
    _close(tl, jl, ATOL)
    period = len(cfg.block_pattern)
    crossed = [i for i, c in enumerate(cache) if "cross_k" in c]
    assert len(crossed) == sum("cross" in jcache[f"slot{i % period}"]
                               for i in range(cfg.n_layers))
    for i in crossed:
        ref = jcache[f"slot{i % period}"]["cross"]
        _close(cache[i]["cross_k"], ref["k"][i // period])
        _close(cache[i]["cross_v"], ref["v"][i // period])
    tl, cache = forward(params, torch.from_numpy(toks[:, s - 1:]), cfg,
                        cache=cache, cache_index=s - 1)
    jl, _, jcache = jx_forward(jparams, jnp.asarray(toks[:, s - 1:]), jcfg,
                               cache=jcache,
                               cache_index=jnp.asarray(s - 1, jnp.int32))
    _close(tl, jl, ATOL)
    _close(tl[:, 0], full[:, -1].numpy(), ATOL)
    for step in range(3):
        lengths = np.asarray([s + step, s + step], np.int32)
        tok = _tokens(9 + step, (b, 1), cfg.vocab_size)
        tl, cache = forward(params, torch.from_numpy(tok), cfg, cache=cache,
                            lengths=lengths)
        jl, _, jcache = jx_forward(jparams, jnp.asarray(tok), jcfg,
                                   cache=jcache, lengths=jnp.asarray(lengths))
        _close(tl, jl, ATOL)


def _spy(monkeypatch):
    calls = Counter()
    for name in kernels.WRAPPERS:
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


@pytest.mark.parametrize("call", ["decode", "prefill_with_inputs"])
@pytest.mark.parametrize("name", NAMES)
def test_launches_equal_the_reference_fused_plan(name, call, monkeypatch):
    """The served decode step (a one-row cross cache, as the engine builds
    it) and a prefill with the cross inputs (the encoder, or the patch
    states, writing the cross caches) launch ``rmsnorm_matmul`` and
    ``residual_rmsnorm`` at the windows the reference's fused plan finds
    in its own traced call, as many times each (``norm_x`` and a later
    slot's ``norm1`` fuse the residual add before them; the encoder's
    ``enc_norm`` fuses its last residual add), and an attention kernel at
    every self- and cross-attention."""
    jcfg, cfg, jparams, params = _model(name)
    b = 2
    if call == "decode":
        src, s = 1, 1
        jin, tin = {}, {}
        lengths = np.asarray([4, 5], np.int32)
        jkw, tkw = dict(lengths=jnp.asarray(lengths)), dict(lengths=lengths)
    else:
        src, s = cfg.n_frontend_tokens, 6
        jin, tin = _inputs(cfg, 10, b)
        jkw, tkw = {}, {}
    jcache = jx_make_cache(jcfg, b, T, src_len=src)

    def fn(p, c, t, *e):
        return jx_forward(p, t, jcfg, cache=c, unroll=True,
                          **dict(zip(jin, e)), **jkw)[0]
    trace = trace_fn(fn, jparams, jcache, jnp.zeros((b, s), jnp.int32),
                     *jin.values())
    ref = Counter(m.rule_name for m in find_matches(trace, verify=False))
    calls = _spy(monkeypatch)
    forward(params, torch.zeros((b, s), dtype=torch.int32), cfg,
            cache=make_cache(cfg, b, T, src_len=src, device="cpu"),
            **tin, **tkw)
    encoder = call != "decode" and cfg.n_encoder_layers > 0
    assert dict(ref) == norm_launches(cfg, encoder=encoder)
    attention = "decode_attention" if call == "decode" else "flash_attention"
    n_attn = attention_launches(cfg) + (cfg.n_encoder_layers if encoder
                                        else 0)
    assert calls == {**ref, attention: n_attn}


@pytest.mark.parametrize("name", NAMES)
def test_cross_layers_without_a_source_raise(name):
    """A forward with neither the cross inputs nor a cache has no K/V for
    its cross layers: it raises, as the reference's assertion does; so
    does a cross cache built for another source length."""
    _, cfg, _, params = _model(name)
    toks = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="cross cache"):
        forward(params, toks, cfg)
    _, tin = _inputs(cfg, 11, 1)
    with pytest.raises(ValueError, match="src_len"):
        forward(params, toks, cfg, cache=make_cache(cfg, 1, 8, src_len=1,
                                                    device="cpu"), **tin)
