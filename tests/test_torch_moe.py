"""The port's mixture-of-experts layer and the MoE and hybrid stacks
against the JAX package, in f32 on the CPU.

``route``, ``capacity``, ``dispatch_slots``, ``moe_local_fwd`` (with
capacity drops at ``capacity_factor=1.0``) and ``moe_dense_fwd`` agree
within 2e-5; reduced Moonlight, Kimi K2 and Jamba logits within 1e-4 of
``repro.models.forward`` (a prefill and decode steps); the bridge carries
the router, the expert tensors and Mamba's f32 leaves bit for bit, Jamba's
eight slots in slot order; and the forward launches the fused norm
kernels at the reference's fused-plan windows.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core.tracing import trace_fn
from repro.layers import moe as jx_moe
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro.runtime.rules import find_matches
from repro_torch import bridge, kernels
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.layers import moe
from repro_torch.models import forward, layer_has_moe, make_cache

torch.set_num_threads(2)
NAMES = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b")
TOL = 2e-5
LOGIT_ATOL = 1e-4
T = 24


def _cfgs(name, **kw):
    jcfg, cfg = jx_reduced(jx_get_config(name)), reduced(get_config(name))
    if kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))
    return jcfg, cfg


def _model(name, seed=0):
    jcfg, cfg = _cfgs(name)
    jparams = jx_init_params(jax.random.PRNGKey(seed), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_the_reference(name):
    for mk_j, mk_t in ((lambda c: c, lambda c: c), (jx_reduced, reduced)):
        jc, tc = mk_j(jx_get_config(name)), mk_t(get_config(name))
        for f in tc.__dataclass_fields__:
            a, b = getattr(jc, f), getattr(tc, f)
            if f in ("moe", "mamba") and a is not None:
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f
        assert jc.hd == tc.hd and jc.n_superblocks == tc.n_superblocks


def _layer(name, seed=0, **kw):
    jcfg, cfg = _cfgs(name, **kw)
    jp = jx_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jcfg, cfg, jp, p


def test_route_capacity_and_slots_match():
    jcfg, cfg, jp, p = _layer("moonshot-v1-16b-a3b")
    x = _x(1, (T, cfg.d_model))
    gates, eids, aux = moe.route(torch.from_numpy(x), p["router"], cfg)
    jg, je, ja = jx_moe.route(jnp.asarray(x), jp["router"], jcfg)
    _close(gates, jg)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(je))
    _close(aux, ja)
    # ties resolve lower index first, as jax.lax.top_k's
    probs = torch.tensor([[0.3, 0.2, 0.3, 0.2]]).log()
    tie = moe.route(probs, torch.eye(4), cfg.replace(
        moe=dataclasses.replace(cfg.moe, top_k=3)))[1]
    assert tie.tolist() == [[0, 2, 1]]
    for t in (1, 2, 4, 13, 16, 48, 300):
        for c in (cfg, cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=1.0))):
            jc = jcfg.replace(moe=dataclasses.replace(
                jcfg.moe, capacity_factor=c.moe.capacity_factor))
            assert moe.capacity(t, c) == jx_moe.capacity(t, jc), t
    for cap in (8, 4, 2):
        slot, keep = moe.dispatch_slots(eids, cfg.moe.n_experts, cap)
        js, jk = jx_moe.dispatch_slots(je, jcfg.moe.n_experts, cap)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(js))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    assert not keep.all()                      # cap 2 drops


@pytest.mark.parametrize("name,cf", [("moonshot-v1-16b-a3b", None),
                                     ("moonshot-v1-16b-a3b", 1.0),
                                     ("jamba-1.5-large-398b", 1.0)])
def test_moe_forward_matches_the_reference(name, cf):
    """The local dispatch and the dense oracle; at capacity factor 1.0 the
    call drops assignments, and the port drops the same ones."""
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, cfg, jp, p = _layer(name, 2, **kw)
    x = _x(3, (2, T, cfg.d_model))
    out, aux = moe.moe_local_fwd(p, torch.from_numpy(x), cfg)
    jout, jaux = jx_moe.moe_local_fwd(jp, jnp.asarray(x), jcfg)
    _close(out, jout)
    _close(aux, jaux)
    dout, daux = moe.moe_dense_fwd(p, torch.from_numpy(x), cfg)
    jdout, _ = jx_moe.moe_dense_fwd(jp, jnp.asarray(x), jcfg)
    _close(dout, jdout)
    _close(daux, jaux)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    eids = moe.route(xt, p["router"], cfg)[1]
    _, keep = moe.dispatch_slots(eids, cfg.moe.n_experts,
                                 moe.capacity(xt.shape[0], cfg))
    assert (not keep.all()) == (cf is not None)
    if cf is not None:           # a drop changes the output
        assert (out - dout).abs().max() > 10 * TOL
    served, none = moe.moe_fwd(p, torch.from_numpy(x), cfg, with_aux=False)
    assert torch.equal(served, out) and none is None


def test_moe_fwd_refuses_a_mesh():
    """Expert parallelism runs inside a rank (tests/test_torch_moe_ep.py):
    a mesh context without one is refused."""
    from repro_torch.launch.mesh import make_host_mesh
    _, cfg, _, p = _layer("moonshot-v1-16b-a3b")
    dist = moe.MeshContext(make_host_mesh(model=2, device="cpu"),
                           ("data",), "model")
    with pytest.raises(ValueError, match="inside a rank"):
        moe.moe_fwd(p, torch.zeros(1, 1, cfg.d_model), cfg, dist=dist)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_moe_and_mamba_leaves(dtype):
    name = "jamba-1.5-large-398b"
    jcfg = jx_reduced(jx_get_config(name), param_dtype=dtype,
                      compute_dtype=dtype)
    cfg = reduced(get_config(name), param_dtype=dtype, compute_dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jx_init_params(jax.random.PRNGKey(1), jcfg))
    params = bridge.params_from_jax(jparams, cfg, device="cpu")
    period = len(cfg.block_pattern)
    assert len(params["blocks"]) == cfg.n_layers
    for i, blk in enumerate(params["blocks"]):
        sb, slot = divmod(i, period)
        ref = jparams["blocks"][f"slot{slot}"]
        assert ("moe" in blk) == layer_has_moe(cfg, i) == ("moe" in ref)
        assert set(blk) == set(ref)
        for group, leaves in blk.items():
            for k, t in leaves.items():
                want = ref[group][k][sb]
                assert tuple(t.shape) == want.shape
                got = t.view(torch.uint16).numpy() if dtype == "bfloat16" \
                    and t.dtype == torch.bfloat16 else t.numpy()
                np.testing.assert_array_equal(
                    got, want.view(np.uint16) if got.dtype == np.uint16
                    else want)
        if "moe" in blk:
            e, d, f = (cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert)
            assert blk["moe"]["router"].dtype == torch.float32
            assert blk["moe"]["w_in"].shape == (e, d, f)
            assert blk["moe"]["w_out"].shape == (e, f, d)
        if cfg.block_pattern[slot] == "mamba":
            for k in ("A_log", "D", "dt_b"):
                assert blk["mixer"][k].dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_the_reference(name):
    """A ragged prefill into the cache, then three decode steps with
    per-row lengths (every MoE call routes both rows together)."""
    jcfg, cfg, jparams, params = _model(name)
    b = 2
    jcache = jx_make_cache(jcfg, b, T, src_len=1)
    cache = make_cache(cfg, b, T, device="cpu")
    toks = _tokens(4, (b, 9), cfg.vocab_size)
    jl, _, jcache = jx_forward(jparams, jnp.asarray(toks), jcfg,
                               cache=jcache)
    tl, _ = forward(params, torch.from_numpy(toks), cfg, cache=cache)
    _close(tl, jl, LOGIT_ATOL)
    for step in range(3):
        lengths = np.asarray([9 + step, 9 + step], np.int32)
        tok = _tokens(5 + step, (b, 1), cfg.vocab_size)
        jl, _, jcache = jx_forward(jparams, jnp.asarray(tok), jcfg,
                                   cache=jcache, lengths=jnp.asarray(lengths))
        tl, _ = forward(params, torch.from_numpy(tok), cfg, cache=cache,
                        lengths=lengths)
        _close(tl, jl, LOGIT_ATOL)
    for i, c in enumerate(cache):
        ref = jcache[f"slot{i % len(cfg.block_pattern)}"]
        sb = i // len(cfg.block_pattern)
        if "h" in c:                         # a Mamba layer's state
            _close(c["h"], ref["mamba"]["h"][sb])
            _close(c["conv"], ref["mamba"]["conv"][sb])


def _spy(monkeypatch):
    calls = Counter()
    for name in kernels.WRAPPERS:
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_launches_equal_the_reference_fused_plan(name, monkeypatch):
    """A decode step launches ``rmsnorm_matmul`` and ``residual_rmsnorm``
    at the windows the reference's fused plan finds in its own traced
    decode step (a superblock's first norm1 with the mixer's input
    product, every other norm with its residual add, the final norm with
    the untied unembed's product), as many times each."""
    jcfg, cfg, jparams, params = _model(name)
    b, s = 2, 1
    jcache = jx_make_cache(jcfg, b, T, src_len=1)
    lengths = np.asarray([4, 5], np.int32)

    def dec(p, c, t, n):
        return jx_forward(p, t, jcfg, cache=c, lengths=n, unroll=True)[0]
    trace = trace_fn(dec, jparams, jcache, jnp.zeros((b, s), jnp.int32),
                     jnp.asarray(lengths))
    ref, final = Counter(), []
    for m in find_matches(trace, verify=False):
        ops = {trace.kernels[i].operator for i in m.indices}
        ref[m.rule_name] += 1
        if any(op.startswith("final_norm") for op in ops):
            final.append((m.rule_name, sorted(ops)))
    assert final == [("rmsnorm_matmul", ["final_norm", "unembed"])]
    calls = _spy(monkeypatch)
    forward(params, torch.zeros((b, s), dtype=torch.int32), cfg,
            cache=make_cache(cfg, b, T, device="cpu"), lengths=lengths)
    n_attn = sum(k != "mamba" for k in cfg.block_pattern) \
        * cfg.n_superblocks
    assert calls == {**ref, "decode_attention": n_attn}


def test_traced_step_prices_the_moe_and_mamba_ops():
    """Every aten op of a traced Jamba decode step has a cost, the
    dispatch's sort, search and scatter and the scan's softplus and exp
    among them; attribution files them under ``moe`` and ``mamba``."""
    from repro_torch.core.tracing import trace_fn as pt_trace_fn
    from repro_torch.telemetry.attribution import parse_operator
    _, cfg, _, params = _model("jamba-1.5-large-398b")
    cache = make_cache(cfg, 2, T, device="cpu")
    tr = pt_trace_fn(
        lambda p, c, t, n: forward(p, t, cfg, cache=c, lengths=n)[0],
        params, cache, torch.zeros((2, 1), dtype=torch.int32),
        torch.tensor([4, 5], dtype=torch.int32))
    by_op = {}
    for k in tr.kernels:
        by_op.setdefault(parse_operator(k.operator, k.name).op,
                         set()).add(k.name)
        assert k.bytes > 0 or k.name in ("view", "_unsafe_view", "expand",
                                         "slice", "select"), k.name
    assert {"sort", "searchsorted", "scatter_", "index_copy_"} \
        <= by_op["moe"]
    assert {"softplus", "exp"} <= by_op["mamba"]
    flops = {k.name: k.flops for k in tr.kernels
             if k.name in ("sort", "searchsorted", "softplus")}
    assert all(f > 0 for f in flops.values()) and len(flops) == 3
