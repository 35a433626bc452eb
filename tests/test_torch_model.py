"""The port's model against ``repro.models.forward`` on reduced SmolLM.

Reference weights go through ``repro_torch.bridge`` (bit for bit); the
port's forward on the CPU runs the kernels' plain versions.  Logits agree
within atol 1e-4 in f32 for a forward without cache, a prefill into the
cache and per-row decode steps (one row writing past the cache, which
must drop), and the forward calls each kernel wrapper where the
reference's fused plan substitutes its kernels.
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
from repro.models import make_cache as jx_make_cache
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.models import forward, init_params, make_cache

torch.set_num_threads(2)
ATOL = 1e-4
T = 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_configs_match_the_reference():
    for name in ("smollm-360m",):
        for mk_j, mk_t in ((lambda c: c, lambda c: c),
                           (jx_reduced, reduced)):
            jc, tc = mk_j(jx_get_config(name)), mk_t(get_config(name))
            for f in tc.__dataclass_fields__:
                if f not in ("moe", "mamba"):
                    assert getattr(jc, f) == getattr(tc, f), f
            assert str(tc.pdtype).split(".")[-1] == jc.pdtype.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_is_bit_exact(dtype):
    jcfg = jx_reduced(jx_get_config("smollm-360m"), param_dtype=dtype,
                      compute_dtype=dtype)
    cfg = reduced(get_config("smollm-360m"), param_dtype=dtype,
                  compute_dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jx_init_params(jax.random.PRNGKey(1), jcfg))
    params = bridge.params_from_jax(jparams, cfg, device="cpu")
    assert len(params["blocks"]) == cfg.n_layers
    pairs = [(jparams["embed"], params["embed"]),
             (jparams["final_norm"]["scale"], params["final_norm"]["scale"])]
    slot = jparams["blocks"]["slot0"]
    for i, blk in enumerate(params["blocks"]):
        for group in ("mixer", "mlp"):
            for name, t in blk[group].items():
                pairs.append((slot[group][name][i], t))
        pairs.append((slot["norm1"]["scale"][i], blk["norm1"]["scale"]))
    for ref, t in pairs:
        assert t.dtype == cfg.pdtype and tuple(t.shape) == ref.shape
        want = ref.view(np.uint16) if dtype == "bfloat16" else ref
        got = t.view(torch.int16).numpy().view(np.uint16) \
            if dtype == "bfloat16" else t.numpy()
        np.testing.assert_array_equal(got, want)


def test_forward_without_cache(setup):
    jcfg, cfg, jparams, params = setup
    toks = _tokens(0, (2, 7), cfg.vocab_size)
    jl, _, _ = jx_forward(jparams, jnp.asarray(toks), jcfg)
    tl, cache = forward(params, torch.from_numpy(toks), cfg)
    assert cache is None and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_prefill_then_per_row_decode(setup):
    jcfg, cfg, jparams, params = setup
    toks = _tokens(1, (3, 8), cfg.vocab_size)
    jc = jx_make_cache(jcfg, 3, T, src_len=1, dtype=jcfg.cdtype)
    tc = make_cache(cfg, 3, T, device="cpu")
    jl, _, jc = jx_forward(jparams, jnp.asarray(toks), jcfg, cache=jc,
                           cache_index=jnp.zeros((), jnp.int32))
    tl, tc = forward(params, torch.from_numpy(toks), cfg, cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # ragged rows; the last step puts row 0 past the cache (write drops)
    for step, lens in enumerate(([8, 3, 5], [9, 4, 6], [T, 5, 7])):
        tok = _tokens(10 + step, (3, 1), cfg.vocab_size)
        lens = np.asarray(lens, np.int32)
        jl, _, jc = jx_forward(jparams, jnp.asarray(tok), jcfg, cache=jc,
                               lengths=jnp.asarray(lens))
        tl, tc = forward(params, torch.from_numpy(tok), cfg, cache=tc,
                         lengths=lens)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tc[i][name].numpy(),
                np.asarray(jc["slot0"]["self"][name][i]), atol=ATOL)


def _spy(monkeypatch):
    calls = {name: 0 for name in kernels.WRAPPERS}
    for name, fn in kernels.WRAPPERS.items():
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


def test_forward_calls_the_kernels_where_the_fused_plan_does(setup,
                                                             monkeypatch):
    _, cfg, _, params = setup
    n = cfg.n_layers
    calls = _spy(monkeypatch)
    cache = make_cache(cfg, 2, T, device="cpu")
    forward(params, torch.from_numpy(_tokens(2, (2, 8), cfg.vocab_size)),
            cfg, cache=cache)
    assert calls == {"rmsnorm_matmul": n, "residual_rmsnorm": n + 1,
                     "flash_attention": n, "decode_attention": 0,
                     "paged_decode_attention": 0,
                     "paged_decode_attention_quant": 0, "rmsnorm": 0,
                     "wkv6": 0}
    for name in calls:
        calls[name] = 0
    forward(params, torch.from_numpy(_tokens(3, (2, 1), cfg.vocab_size)),
            cfg, cache=cache, lengths=np.array([8, 8]))
    assert calls == {"rmsnorm_matmul": n, "residual_rmsnorm": n + 1,
                     "flash_attention": 0, "decode_attention": n,
                     "paged_decode_attention": 0,
                     "paged_decode_attention_quant": 0, "rmsnorm": 0,
                     "wkv6": 0}


def test_unported_features_raise():
    from repro_torch.configs import MoEConfig
    cfg = reduced(get_config("smollm-360m"))
    gen = torch.Generator().manual_seed(0)
    moe = cfg.replace(moe=MoEConfig(n_experts=4, top_k=2, d_expert=64),
                      moe_slots=(0,))
    for bad in (moe, cfg.replace(n_encoder_layers=2),
                cfg.replace(frontend="vision", n_frontend_tokens=8),
                cfg.replace(block_pattern=("attn", "xattn"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_params(bad, gen, device="cpu")
    params = init_params(cfg, gen, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward(params, torch.zeros((1, 2), dtype=torch.int32), cfg,
                cache=make_cache(cfg, 1, 8, device="cpu"),
                lengths=np.array([1]))
    # the reference's MoE layers are not ported; the port's forward refuses
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward(params, torch.zeros((1, 2), dtype=torch.int32), moe)
    assert params["embed"].shape == (cfg.vocab_size, cfg.d_model)


def test_unported_messages_name_their_roadmap_item():
    """Each refusal names its ROADMAP Queue A item by name, not by a
    number that a renumbering would leave stale."""
    import re

    from repro_torch.inference.backends import LocalBackend, make_backend
    from repro_torch.models import check_supported
    cfg = reduced(get_config("smollm-360m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    backend = LocalBackend(cfg, params, max_batch=1, max_len=8, device="cpu")
    calls = {
        "tensor parallel": lambda: make_backend(cfg, params, max_batch=1,
                                                max_len=8, tp=2),
        "measured characterization and autotune": lambda: LocalBackend(
            cfg, params, max_batch=1, max_len=8, plan="autotuned",
            device="cpu"),
        "speculative decoding": lambda: backend.verify(None, None, None),
        "model features": lambda: check_supported(
            cfg.replace(n_encoder_layers=2)),
    }
    for item, call in calls.items():
        with pytest.raises((ValueError, NotImplementedError)) as err:
            call()
        msg = str(err.value)
        assert "ROADMAP" in msg and item in msg, msg
        assert not re.search(r"item \d", msg), msg


def test_layer_primitives_match_the_reference():
    """layers.common against the reference's: the norm (both forms),
    RoPE, the gated and plain MLP, softcap and the untied unembed."""
    from repro.layers import common as jx
    from repro_torch.configs.base import ModelConfig
    from repro_torch.layers import common as tc
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.array([[0, 1, 2, 7, 31], [3, 4, 5, 6, 100]], np.int32)
    for plus_one in (False, True):
        np.testing.assert_allclose(
            tc.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                       plus_one=plus_one).numpy(),
            np.asarray(jx.rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                  plus_one=plus_one)), atol=1e-6)
    tables = tc.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(
        tc.apply_rope(torch.from_numpy(x), tables).numpy(),
        np.asarray(jx.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        atol=1e-5)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    mats = {k: rng.standard_normal(s).astype(np.float32) * 0.3 for k, s in
            (("w_in", (16, 24)), ("w_gate", (16, 24)), ("w_out", (24, 16)))}
    for glu, act in ((True, "silu"), (False, "gelu")):
        cfg = ModelConfig("t", "dense", 1, 16, 2, 2, 24, 10, glu=glu,
                          act=act, final_softcap=30.0,
                          param_dtype="float32", compute_dtype="float32")
        p = {k: v for k, v in mats.items() if glu or k != "w_gate"}
        np.testing.assert_allclose(
            tc.mlp_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(h), cfg).numpy(),
            np.asarray(jx.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(h), cfg)), atol=1e-5)
    head = rng.standard_normal((16, 10)).astype(np.float32)
    np.testing.assert_allclose(
        tc.unembed(torch.from_numpy(h), None, torch.from_numpy(head),
                   cfg).numpy(),
        np.asarray(jx.unembed(jnp.asarray(h), None, jnp.asarray(head), cfg)),
        atol=1e-5)
