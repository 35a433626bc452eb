"""The paper's workloads and the remaining dense decoders against the
reference, on reduced configs in f32 on the CPU.

For each of Llama-3.2-1B, GPT-2, InternLM2-20B, CodeQwen1.5-7B (qkv bias,
drawn non-zero in the reference's params before bridging: its zero init
would hide a dropped bias), Gemma-2-27B (sliding-window and global layers,
soft-capped scores; reduced window 8) and the encoders BERT and XLM-R
(non-causal):

* the config, full and reduced, equals the reference's field by field;
* ``bridge.params_from_jax`` is bit-exact, biases and Gemma-2's two slots
  (superblock-major, then slot) included;
* logits within 1e-4 of ``repro.models.forward``: without cache, and for
  a prefill and per-row decode steps past position 8 on the contiguous
  cache (the paged pool's in ``test_torch_dense_paged.py``);
* each attention layer passes its window and the config's softcap to the
  kernel wrappers, an encoder's prefill runs flash non-causal;
* the decode plain versions with ``window`` and ``softcap`` within 2e-5 of
  the reference model's ``mha``.
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
from repro_torch import bridge, kernels
from repro_torch.configs import PAPER_WORKLOADS, get_config, reduced
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_quant_ref,
    paged_decode_attention_ref)
from repro_torch.models import forward, layer_window, make_cache

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
        _MODELS[name] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree), params,
                         tree)
    return _MODELS[name][:4]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_the_paper_workloads_are_registered():
    from repro.configs import PAPER_WORKLOADS as JX_PAPER
    from repro.configs import list_configs as jx_list_configs
    from repro_torch.configs import list_configs
    assert PAPER_WORKLOADS == JX_PAPER
    assert set(NEW) | {"smollm-360m", "rwkv6-3b", "moonshot-v1-16b-a3b",
                       "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
                       "llama-3.2-vision-11b", "seamless-m4t-medium"} \
        == set(list_configs()) == set(jx_list_configs())


@pytest.mark.parametrize("name", NEW)
def test_config_matches_the_reference(name):
    for mk_j, mk_t in ((lambda c: c, lambda c: c), (jx_reduced, reduced)):
        jc, tc = mk_j(jx_get_config(name)), mk_t(get_config(name))
        for f in tc.__dataclass_fields__:
            assert getattr(jc, f) == getattr(tc, f), f
        assert jc.hd == tc.hd and jc.n_superblocks == tc.n_superblocks


@pytest.mark.parametrize("name", NEW)
def test_bridge_is_bit_exact(name):
    _, cfg, _, params = model(name)
    tree = _MODELS[name][4]
    pat = len(cfg.block_pattern)
    assert len(params["blocks"]) == cfg.n_layers

    def same(ref, t):
        assert tuple(t.shape) == ref.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), ref)

    def walk(ref, t, pick):
        assert set(ref) == set(t)
        for k, v in ref.items():
            if isinstance(v, dict):
                walk(v, t[k], pick)
            else:
                same(pick(v), t[k])

    walk({k: v for k, v in tree.items() if k != "blocks"},
         {k: v for k, v in params.items() if k != "blocks"}, lambda a: a)
    for i, blk in enumerate(params["blocks"]):
        sb, slot = divmod(i, pat)
        walk(tree["blocks"][f"slot{slot}"], blk, lambda a, sb=sb: a[sb])
    if cfg.qkv_bias:
        assert all(np.abs(blk["mixer"]["bq"].numpy()).max() > 0.1
                   for blk in params["blocks"])


@pytest.mark.parametrize("name", NEW)
def test_forward_without_cache(name):
    jcfg, cfg, jparams, params = model(name)
    toks = _tokens(0, (2, 11), cfg.vocab_size)     # past the window of 8
    jl, _, _ = jx_forward(jparams, jnp.asarray(toks), jcfg)
    tl, _ = forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("name", NEW)
def test_prefill_then_per_row_decode(name):
    """A 6-token prefill of 3 rows, then 6 per-row decode steps at ragged
    lengths up to 11: Gemma-2's local layers' window of 8 bites."""
    jcfg, cfg, jparams, params = model(name)
    toks = _tokens(1, (3, 6), cfg.vocab_size)
    jc = jx_make_cache(jcfg, 3, T, src_len=1, dtype=jcfg.cdtype)
    tc = make_cache(cfg, 3, T, device="cpu")
    jl, _, jc = jx_forward(jparams, jnp.asarray(toks), jcfg, cache=jc,
                           cache_index=jnp.zeros((), jnp.int32))
    tl, tc = forward(params, torch.from_numpy(toks), cfg, cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    lens = np.array([6, 3, 5], np.int32)
    for step in range(6):
        tok = _tokens(10 + step, (3, 1), cfg.vocab_size)
        jl, _, jc = jx_forward(jparams, jnp.asarray(tok), jcfg, cache=jc,
                               lengths=jnp.asarray(lens))
        tl, tc = forward(params, torch.from_numpy(tok), cfg, cache=tc,
                         lengths=lens)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {step}")
        lens = lens + 1


def _spy(monkeypatch):
    """Record each kernel wrapper call's keyword options."""
    calls = []
    for name, fn in kernels.WRAPPERS.items():
        def counted(*a, _fn=fn, _name=name, **k):
            calls.append((_name, {o: k[o] for o in ("window", "softcap",
                                                    "causal") if o in k}))
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


@pytest.mark.parametrize("name", NEW)
def test_each_layer_passes_its_window_softcap_and_mask(name, monkeypatch):
    _, cfg, _, params = model(name)
    calls = _spy(monkeypatch)
    cache = make_cache(cfg, 2, T, device="cpu")
    forward(params, torch.from_numpy(_tokens(5, (2, 8), cfg.vocab_size)),
            cfg, cache=cache)
    forward(params, torch.from_numpy(_tokens(6, (2, 1), cfg.vocab_size)),
            cfg, cache=cache, lengths=np.array([8, 8]))
    n = cfg.n_layers
    windows = [layer_window(cfg, i) for i in range(n)]
    if name == "gemma2-27b":
        assert windows == [8, 0, 8, 0]
    else:
        assert windows == [0] * n
    flash = [k for nm, k in calls if nm == "flash_attention"]
    decode = [k for nm, k in calls if nm == "decode_attention"]
    causal = cfg.family != "encoder"
    assert flash == [dict(window=w, softcap=cfg.attn_softcap, causal=causal)
                     for w in windows]
    assert decode == [dict(window=w, softcap=cfg.attn_softcap)
                      for w in windows]
    names = [nm for nm, _ in calls]
    n_sb = cfg.n_superblocks        # Gemma-2's global slot fuses its add
    tied = int(cfg.tie_embeddings)  # an untied head fuses the final norm
    assert names.count("rmsnorm_matmul") == 2 * (n_sb + 1 - tied)
    assert names.count("residual_rmsnorm") == 2 * (2 * n - n_sb + tied)


def _mha_decode(q, k, v, lens, scale, window, cap):
    """The reference model's decode attention (``mha`` over the cache with
    ``kv_valid = kv_pos < lens``, the query at lens - 1)."""
    b, t = k.shape[0], k.shape[1]
    qpos = (lens - 1)[:, None].astype(np.int32)
    kpos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    out = jx_mha(jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
                 scale=scale, causal=True, window=window, cap=cap,
                 q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
                 kv_valid=jnp.asarray(kpos < lens[:, None]))
    return np.asarray(out)[:, 0]


@pytest.mark.parametrize("window,cap", [(0, 50.0), (5, 0.0), (5, 50.0),
                                        (40, 30.0)])
@pytest.mark.parametrize("hq,hkv,hd", [(4, 4, 128), (8, 4, 128),
                                       (12, 2, 128), (4, 2, 16)])
def test_decode_plain_with_window_and_softcap_matches_mha(hq, hkv, hd,
                                                          window, cap):
    """GQA groups 1, 2 and 6 at hd 128 (CodeQwen / GPT-2, Gemma-2,
    InternLM2) and the reduced configs' 2 at hd 16; lengths below, at and
    past the window, one row of a single position."""
    rng = np.random.default_rng(hq * 1000 + hkv + window)
    b, t = 4, 24
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    lens = np.array([24, 13, 5, 1], np.int32)
    scale = 0.0625 if hd == 128 else hd ** -0.5
    want = _mha_decode(q, k, v, lens, scale, window, cap)
    kt = torch.from_numpy(k).transpose(1, 2)
    vt = torch.from_numpy(v).transpose(1, 2)
    got = decode_attention_ref(torch.from_numpy(q), kt, vt,
                               torch.from_numpy(lens), scale=scale,
                               window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    wrapped = kernels.decode_attention(torch.from_numpy(q), kt, vt,
                                       torch.from_numpy(lens), scale=scale,
                                       window=window, softcap=cap)
    assert torch.equal(wrapped, got)
    # the same cache as pages of 4 tokens behind a permuted block table
    bs, nb = 4, t // 4
    perm = rng.permutation(b * nb)
    table = perm.reshape(b, nb).astype(np.int32)
    kp = np.empty((b * nb, bs, hkv, hd), np.float32)
    vp = np.empty_like(kp)
    kp[table.reshape(-1)] = k.reshape(b * nb, bs, hkv, hd)
    vp[table.reshape(-1)] = v.reshape(b * nb, bs, hkv, hd)
    args = (torch.from_numpy(table), torch.from_numpy(lens))
    paged = paged_decode_attention_ref(torch.from_numpy(q),
                                       torch.from_numpy(kp),
                                       torch.from_numpy(vp), *args,
                                       scale=scale, window=window,
                                       softcap=cap)
    np.testing.assert_allclose(paged.numpy(), want, atol=2e-5, rtol=2e-5)
    assert torch.equal(kernels.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        *args, scale=scale, window=window, softcap=cap), paged)
    # int8 pages: the plain version dequantizes, then attends the same way
    kq = rng.integers(-127, 128, kp.shape).astype(np.int8)
    vq = rng.integers(-127, 128, vp.shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, kp.shape[:3]).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, vp.shape[:3]).astype(np.float32)
    kd = (kq.astype(np.float32) * ks[..., None])[table].reshape(b, t, hkv,
                                                                hd)
    vd = (vq.astype(np.float32) * vs[..., None])[table].reshape(b, t, hkv,
                                                                hd)
    quant = paged_decode_attention_quant_ref(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(ks), torch.from_numpy(vs), *args, scale=scale,
        window=window, softcap=cap)
    np.testing.assert_allclose(
        quant.numpy(), _mha_decode(q, kd, vd, lens, scale, window, cap),
        atol=2e-5, rtol=2e-5)


def test_decode_window_must_not_be_negative():
    q = torch.zeros((1, 2, 16))
    k = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="window"):
        kernels.decode_attention(q, k, k, 4, scale=0.25, window=-1)
