"""The port's loss and its gradients against ``repro.models.loss_fn`` and
``jax.grad`` on reduced f32 configs, from the same weights
(``bridge.params_from_jax``) and the same ``make_batch``.

The port's backward goes through the closed-form rules of its custom ops
(``kernels/*/backward.py``); on the CPU their forwards are the plain
versions.  The loss agrees within 1e-5 relative, every gradient within
GRAD_TOL of the largest entry of its leaf (f32, other summation order),
and each remat policy and ``loss_chunks=4`` give the plain call's loss and
gradients.  The gradients part by about 1e-6 of their leaf's largest
entry; GRAD_TOL leaves a factor 20.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import list_configs as jx_list_configs
from repro.configs import reduced as jx_reduced
from repro.data.pipeline import DataConfig as JxDataConfig
from repro.data.pipeline import make_batch as jx_make_batch
from repro.models import init_params as jx_init_params
from repro.models import loss_fn as jx_loss_fn
from repro.models.transformer import active_param_count as jx_active
from repro.models.transformer import param_count as jx_param_count
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import (REMAT_POLICIES, active_param_count,
                                init_params, loss_fn, param_count)

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
# ":drops": capacity factor 0.5, so each expert drops assignments of the
# call's B*S tokens
ARCHS = ("smollm-360m", "internlm2-20b", "gemma2-27b",
         "moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b:drops",
         "seamless-m4t-medium", "llama-3.2-vision-11b")


def _configs(name):
    name, _, variant = name.partition(":")
    jc = jx_get_config(name)
    n = max(2, len(jc.block_pattern))
    jcfg, cfg = jx_reduced(jc, n_layers=n), reduced(get_config(name),
                                                    n_layers=n)
    if variant == "drops":
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=0.5))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    return jcfg, cfg


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _setup(name, seed=0, seq=16):
    jcfg, cfg = _configs(name)
    jparams = jx_init_params(jax.random.PRNGKey(seed), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    batch = jx_make_batch(JxDataConfig(seed=seed, batch=2, seq_len=seq,
                                       vocab_size=jcfg.vocab_size), 3, jcfg)
    return jcfg, cfg, jparams, params, batch


def _port_grads(params, batch, cfg, **kw):
    for _, leaf in _leaves(params):
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, (ce, aux) = loss_fn(params, batch, cfg, **kw)
    loss.backward()
    return loss.item(), aux.item(), {k: leaf.grad for k, leaf in
                                     _leaves(params)}


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_the_reference(name):
    jcfg, cfg, jparams, params, batch = _setup(name)
    (jloss, (_, jaux)), jgrads = jax.value_and_grad(
        lambda p: jx_loss_fn(p, batch, jcfg, remat=False),
        has_aux=True)(jparams)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                  device="cpu")
    loss, aux, grads = _port_grads(params, batch, cfg, remat=False)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(aux - float(jaux)) <= LOSS_RTOL * max(1.0, abs(float(jaux)))
    if cfg.moe is not None:
        assert aux > 0
    for key, w in _leaves(want):
        g = grads[key]
        assert g is not None and g.shape == w.shape, key
        scale = max(w.abs().max().item(), 1e-6)
        err = (g - w).abs().max().item()
        assert err <= GRAD_TOL * scale, (key, err, scale)


@pytest.mark.parametrize("name", ["smollm-360m", "moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium"])
def test_remat_policies_and_chunked_loss_equal_the_plain_call(name):
    _, cfg, _, params, batch = _setup(name, seed=1)
    base_loss, _, base = _port_grads(params, batch, cfg, remat=False)
    runs = [dict(remat=True, remat_policy=p) for p in REMAT_POLICIES]
    runs.append(dict(remat=False, loss_chunks=4))
    for kw in runs:
        loss, _, grads = _port_grads(params, batch, cfg, **kw)
        assert abs(loss - base_loss) <= 1e-6 * abs(base_loss), kw
        for key, g in grads.items():
            torch.testing.assert_close(g, base[key], rtol=1e-5, atol=1e-7,
                                       msg=lambda m: f"{kw} {key}: {m}")


def test_chunked_loss_matches_the_reference_chunked_loss():
    jcfg, cfg, jparams, params, batch = _setup("internlm2-20b", seed=2)
    jloss, _ = jx_loss_fn(jparams, batch, jcfg, remat=False, loss_chunks=4)
    loss, _, _ = _port_grads(params, batch, cfg, remat=False, loss_chunks=4)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    with pytest.raises(ValueError, match="loss chunks"):
        loss_fn(params, batch, cfg, loss_chunks=5)


def test_param_counts_match_the_reference():
    for name in jx_list_configs():
        jcfg = jx_reduced(jx_get_config(name))
        cfg = reduced(get_config(name))
        shapes = jax.eval_shape(lambda: jx_init_params(
            jax.random.PRNGKey(0), jcfg))
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        assert param_count(params) == jx_param_count(shapes), name
        assert active_param_count(params, cfg) == \
            jx_active(shapes, jcfg), name


def test_make_batch_equals_the_reference():
    for name in ("smollm-360m", "seamless-m4t-medium",
                 "llama-3.2-vision-11b"):
        jcfg, cfg = _configs(name)
        for seed, index in ((0, 0), (7, 5), (3, 1 << 20)):
            kw = dict(seed=seed, batch=2, seq_len=24,
                      vocab_size=cfg.vocab_size)
            want = jx_make_batch(JxDataConfig(**kw), index, jcfg)
            got = make_batch(DataConfig(**kw), index, cfg)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_remat_policies_recompute_what_they_do_not_save(monkeypatch):
    """The backward recomputes a layer's kernel calls unless its policy
    saves their outputs: "dots" keeps flash attention and the fused
    norm+product, "dots_no_batch" only the product (attention has batch
    dims), "nothing" and "names" (which keeps the sub-blocks' outputs)
    neither.  Counted on the ops' plain versions, which run them here."""
    import importlib
    calls = {"flash_attention": 0, "rmsnorm_matmul": 0}
    for name, ref in (("flash_attention", "attention_ref"),
                      ("fused.rmsnorm_matmul", "rmsnorm_matmul_ref")):
        mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
        key = name.rsplit(".", 1)[-1]

        def spy(*a, _fn=getattr(mod, ref), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, ref, spy)
    _, cfg, _, params, batch = _setup("smollm-360m", seed=3)
    for _, leaf in _leaves(params):
        leaf.requires_grad_(True)
    want = {"nothing": (2, 2), "dots": (0, 0), "dots_no_batch": (2, 0),
            "names": (2, 2)}
    for policy, (n_flash, n_rmm) in want.items():
        loss, _ = loss_fn(params, batch, cfg, remat=True,
                          remat_policy=policy)
        calls.update(flash_attention=0, rmsnorm_matmul=0)
        loss.backward()
        assert (calls["flash_attention"], calls["rmsnorm_matmul"]) == \
            (n_flash, n_rmm), policy
    with pytest.raises(ValueError, match="remat_policy"):
        loss_fn(params, batch, cfg, remat=True, remat_policy="everything")
