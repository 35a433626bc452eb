"""The port's RWKV-6 path against the reference on reduced ``rwkv6-3b``.

The plain versions of the two kernels this slice ports (``wkv6`` and the
legacy two-output ``rmsnorm``) against the Pallas kernels in interpret mode
and their oracles, on the grids of ``tests/test_kernels.py``; the time mix,
the channel mix and whole-model logits (a prefill, then batched decode
steps) against ``repro`` in f32 within 1e-4; the bridge on the RWKV tree
bit for bit.  Inputs come from numpy seeds and go to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.kernels.rmsnorm.ops import rmsnorm as jx_rmsnorm
from repro.kernels.rwkv6.ops import wkv6 as jx_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jx_wkv6_oracle
from repro.layers import rwkv as jx_rwkv
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.rwkv6.ref import wkv6_oracle
from repro_torch.layers import rwkv
from repro_torch.models import (forward, init_params, make_cache,
                                make_paged_cache)

torch.set_num_threads(2)
ATOL = 1e-4
ARCH = "rwkv6-3b"


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _np(shape, seed, scale=1.0, shift=0.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return a.astype(np.float32)


def _wkv_inputs(b, h, t, hd, seed):
    """r, k, v, logw in the layer's (B,T,H,hd) layout, u, s0; the scales of
    ``tests/test_kernels.py::test_wkv6``."""
    r = _np((b, t, h, hd), seed, 0.5)
    k = _np((b, t, h, hd), seed + 1, 0.5)
    v = _np((b, t, h, hd), seed + 2)
    logw = -np.exp(_np((b, t, h, hd), seed + 3, 0.5, -2.0))
    u = _np((h, hd), seed + 4, 0.3)
    s0 = _np((b, h, hd, hd), seed + 5, 0.1)
    return r, k, v, logw, u, s0


def _bhtd(a):
    return jnp.asarray(a.transpose(0, 2, 1, 3))


def _close(got, want, atol, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def test_configs_match_the_reference():
    for mk_j, mk_t in ((lambda c: c, lambda c: c), (jx_reduced, reduced)):
        jc, tc = mk_j(jx_get_config(ARCH)), mk_t(get_config(ARCH))
        for f in tc.__dataclass_fields__:
            if f not in ("moe", "mamba"):
                assert getattr(jc, f) == getattr(tc, f), f
    red = reduced(get_config(ARCH))
    assert (red.d_model, red.n_heads, red.hd, red.d_ff, red.vocab_size,
            red.n_layers) == (64, 4, 16, 128, 503, 2)


@pytest.mark.parametrize("shape", [(1, 2, 32, 16), (2, 3, 45, 8),
                                   (1, 1, 16, 32)])
def test_plain_wkv6_matches_the_pallas_kernel(shape):
    b, h, t, hd = shape
    r, k, v, logw, u, s0 = _wkv_inputs(b, h, t, hd, 10)
    jo, js = jx_wkv6(*(_bhtd(a) for a in (r, k, v, logw)), jnp.asarray(u),
                     jnp.asarray(s0), chunk=16)
    oo, os_ = jx_wkv6_oracle(*(_bhtd(a) for a in (r, k, v, logw)), u, s0)
    o, s = kernels.wkv6(*(torch.from_numpy(a) for a in (r, k, v, logw, u,
                                                        s0)))
    for want_o, want_s in ((jo, js), (oo, os_)):
        _close(o, np.asarray(want_o).transpose(0, 2, 1, 3), 5e-4, 1e-3)
        _close(s, want_s, 5e-4, 1e-3)
    lo, ls = wkv6_oracle(*(torch.from_numpy(a) for a in (r, k, v, logw, u,
                                                         s0)))
    _close(o, lo, 5e-4, 1e-3)
    _close(s, ls, 5e-4, 1e-3)


@pytest.mark.parametrize("t", [16, 32, 48])
def test_chunked_and_step_forms_match_the_reference_layer(t):
    r, k, v, logw, u, s0 = _wkv_inputs(2, 3, t, 16, 20)
    jo, js = jx_rwkv.wkv_chunked(*(jnp.asarray(a) for a in
                                   (r, k, v, logw, u, s0)), chunk=16)
    o, s = rwkv.wkv_chunked(*(torch.from_numpy(a) for a in
                              (r, k, v, logw, u, s0)))
    _close(o, jo, 5e-4, 1e-3)
    _close(s, js, 5e-4, 1e-3)
    jo, js = jx_rwkv.wkv_step(*(jnp.asarray(a[:, 0]) for a in
                                (r, k, v, logw)), jnp.asarray(u),
                              jnp.asarray(s0))
    o, s = kernels.wkv6(*(torch.from_numpy(a[:, :1]) for a in
                          (r, k, v, logw)), torch.from_numpy(u),
                        torch.from_numpy(s0))
    assert o.shape == (2, 1, 3, 16)
    _close(o[:, 0], jo, 1e-5)
    _close(s, js, 1e-5)


def test_wkv6_extreme_decay_stays_finite():
    """Alternating decays of exp(-50) and exp(-1e-4), as the reference's
    overflow-safety test, through the chunked plain version (T 32)."""
    b, h, t, hd = 1, 1, 32, 8
    r, k, v = (_np((b, t, h, hd), s) for s in (30, 31, 32))
    logw = np.where(np.arange(t)[None, :, None, None] % 2 == 0, -50.0,
                    -1e-4).astype(np.float32)
    logw = np.broadcast_to(logw, (b, t, h, hd)).copy()
    u = np.zeros((h, hd), np.float32)
    s0 = np.zeros((b, h, hd, hd), np.float32)
    o, s = kernels.wkv6(*(torch.from_numpy(a) for a in (r, k, v, logw, u,
                                                        s0)))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    oo, os_ = jx_wkv6_oracle(*(_bhtd(a) for a in (r, k, v, logw)), u, s0)
    _close(o, np.asarray(oo).transpose(0, 2, 1, 3), 1e-3, 1e-3)
    _close(s, os_, 1e-3, 1e-3)


def test_wkv6_writes_the_state_in_place():
    r, k, v, logw, u, s0 = _wkv_inputs(2, 3, 5, 16, 40)
    args = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    want_o, want_s = kernels.wkv6(*args, torch.from_numpy(s0))
    state = torch.from_numpy(s0.copy())
    o, s = kernels.wkv6(*args, state, s_out=state)
    assert s is state
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)


@pytest.mark.parametrize("n,d", [(64, 96), (100, 256), (7, 64)])
@pytest.mark.parametrize("with_res", [False, True])
def test_plain_rmsnorm_matches_the_pallas_kernel(n, d, with_res):
    x = _np((n, d), 50)
    w = _np((d,), 51, shift=1.0)
    res = _np((n, d), 52) if with_res else None
    jy, jr = jx_rmsnorm(jnp.asarray(x), jnp.asarray(w),
                        None if res is None else jnp.asarray(res), block_n=32)
    tx = torch.from_numpy(x)
    y, r2 = kernels.rmsnorm(tx, torch.from_numpy(w),
                            None if res is None else torch.from_numpy(res))
    _close(y, jy, 1e-5)
    _close(r2, jr, 1e-6)
    if res is None:
        assert r2 is tx


def _state_pair(jcfg, cfg, b, seed):
    """A non-zero layer state for both sides: (JAX dict, port dict)."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    shift, s, shift_c = (_np((b, d), seed), _np((b, h, hd, hd), seed + 1, 0.1),
                         _np((b, d), seed + 2))
    jst = {"shift": jnp.asarray(shift), "s": jnp.asarray(s),
           "shift_c": jnp.asarray(shift_c)}
    tst = {"shift": torch.from_numpy(shift.copy()),
           "s": torch.from_numpy(s.copy()),
           "shift_c": torch.from_numpy(shift_c.copy())}
    return jst, tst


@pytest.mark.parametrize("seq", [1, 11, 16])
def test_time_and_channel_mix_match_the_reference(setup, seq):
    jcfg, cfg, jparams, params = setup
    blk, jblk = params["blocks"][1], jax.tree.map(
        lambda a: a[1], jparams["blocks"]["slot0"])
    x = _np((2, seq, cfg.d_model), 60)
    jst, tst = _state_pair(jcfg, cfg, 2, 61)
    jo, jnew = jx_rwkv.rwkv_time_fwd(
        jblk["mixer"], jnp.asarray(x), jcfg,
        state={"shift": jst["shift"], "s": jst["s"]})
    o = rwkv.rwkv_time_fwd(blk["mixer"], torch.from_numpy(x), cfg, tst)
    _close(o, jo, ATOL)
    _close(tst["shift"], jnew["shift"], 0)
    _close(tst["s"], jnew["s"], ATOL)
    jo, jnew = jx_rwkv.rwkv_channel_fwd(jblk["mlp"], jnp.asarray(x), jcfg,
                                        state={"shift": jst["shift_c"]})
    o = rwkv.rwkv_channel_fwd(blk["mlp"], torch.from_numpy(x), cfg, tst)
    _close(o, jo, ATOL)
    _close(tst["shift_c"], jnew["shift"], 0)
    # without a state both start from zeros
    jo, _ = jx_rwkv.rwkv_time_fwd(jblk["mixer"], jnp.asarray(x), jcfg)
    _close(rwkv.rwkv_time_fwd(blk["mixer"], torch.from_numpy(x), cfg), jo,
           ATOL)


def test_logits_prefill_then_batched_decode(setup):
    jcfg, cfg, jparams, params = setup
    toks = np.random.default_rng(70).integers(
        0, cfg.vocab_size, (3, 13)).astype(np.int32)
    jl, _, _ = jx_forward(jparams, jnp.asarray(toks), jcfg)
    tl, none = forward(params, torch.from_numpy(toks), cfg)
    assert none is None and tl.dtype == torch.float32
    _close(tl, jl, ATOL)
    jc = jx_make_cache(jcfg, 3, 32, src_len=1, dtype=jcfg.cdtype)
    tc = make_cache(cfg, 3, 32, device="cpu")
    jl, _, jc = jx_forward(jparams, jnp.asarray(toks), jcfg, cache=jc,
                           cache_index=jnp.zeros((), jnp.int32))
    tl, tc = forward(params, torch.from_numpy(toks), cfg, cache=tc)
    _close(tl, jl, ATOL)
    for step in range(3):
        tok = np.random.default_rng(71 + step).integers(
            0, cfg.vocab_size, (3, 1)).astype(np.int32)
        lens = np.array([13, 13, 13], np.int32) + step
        jl, _, jc = jx_forward(jparams, jnp.asarray(tok), jcfg, cache=jc,
                               lengths=jnp.asarray(lens))
        tl, tc = forward(params, torch.from_numpy(tok), cfg, cache=tc,
                         lengths=lens)
        _close(tl, jl, ATOL)
    for i in range(cfg.n_layers):
        for name in ("shift", "s", "shift_c"):
            _close(tc[i][name], jc["slot0"]["rwkv"][name][i], ATOL)


def test_forward_calls_wkv6_and_rmsnorm_per_layer(setup, monkeypatch):
    _, cfg, _, params = setup
    calls = {name: 0 for name in kernels.WRAPPERS}
    for name, fn in kernels.WRAPPERS.items():
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    n = cfg.n_layers
    cache = make_cache(cfg, 2, 16, device="cpu")
    for toks in (np.zeros((2, 5), np.int32), np.ones((2, 1), np.int32)):
        for name in calls:
            calls[name] = 0
        forward(params, torch.from_numpy(toks), cfg, cache=cache,
                lengths=None if toks.shape[1] > 1 else np.array([5, 5]))
        assert calls == {**{k: 0 for k in calls}, "rmsnorm": 2 * n + 1,
                         "wkv6": n}


def test_cache_layout_and_no_paged_cache(setup):
    _, cfg, _, _ = setup
    cache = make_cache(cfg, 3, 8, device="cpu", dtype=torch.bfloat16)
    assert len(cache) == cfg.n_layers
    h, hd = cfg.n_heads, cfg.hd
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache[0].items()} == {
        "shift": ((3, cfg.d_model), torch.bfloat16),
        "s": ((3, h, hd, hd), torch.float32),
        "shift_c": ((3, cfg.d_model), torch.bfloat16)}
    with pytest.raises(ValueError, match="pure-attention"):
        make_paged_cache(cfg, 8, 4, device="cpu")


def test_init_params_shapes_match_the_reference(setup):
    _, cfg, jparams, _ = setup
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jblk = jparams["blocks"]["slot0"]
    for group in ("mixer", "mlp", "norm1", "norm2"):
        for name, t in params["blocks"][0][group].items():
            ref = jblk[group][name]
            assert tuple(t.shape) == ref.shape[1:], (group, name)
            assert str(t.dtype).split(".")[-1] == ref.dtype.name, name
    assert params["lm_head"].shape == jparams["lm_head"].shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_rwkv_tree_bit_for_bit(dtype):
    jcfg = jx_reduced(jx_get_config(ARCH), param_dtype=dtype,
                      compute_dtype=dtype)
    cfg = reduced(get_config(ARCH), param_dtype=dtype, compute_dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jx_init_params(jax.random.PRNGKey(2), jcfg))
    params = bridge.params_from_jax(jparams, cfg, device="cpu")
    assert len(params["blocks"]) == cfg.n_layers
    pairs = [(jparams[k], params[k]) for k in ("embed", "lm_head")]
    pairs.append((jparams["final_norm"]["scale"],
                  params["final_norm"]["scale"]))
    slot = jparams["blocks"]["slot0"]
    for i, blk in enumerate(params["blocks"]):
        assert blk.keys() == slot.keys()
        for group in slot:
            assert blk[group].keys() == slot[group].keys()
            pairs += [(slot[group][name][i], t)
                      for name, t in blk[group].items()]
    f32_leaves = {"w0", "u", "ln_scale", "ln_bias"}
    assert f32_leaves <= set(params["blocks"][0]["mixer"])
    for ref, t in pairs:
        assert tuple(t.shape) == ref.shape
        if ref.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            got = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got, ref.view(np.uint16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), ref)
    for name in f32_leaves:
        assert params["blocks"][0]["mixer"][name].dtype == torch.float32
