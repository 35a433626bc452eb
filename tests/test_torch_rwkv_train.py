"""Training an RWKV-6 stack: the ``wkv6`` op's closed-form backward
(``kernels/rwkv6/backward.py``) and the port's ``loss_fn`` against the
reference's.

* The backward, through the functional entry ``repro_torch::wkv6_fn`` (on
  the CPU its forward is the plain chunked version), against autograd
  through ``wkv6_oracle``'s literal recurrence run in f64: every input's
  gradient (r, k, v, logw, u, s0) for an output gradient and a final-state
  gradient, at T = 1, 5, 16 and 37 (one chunk, a padded chunk, a whole
  chunk, three chunks), with a non-zero initial state, and with a token
  whose log-decay is -60 (the extreme-decay case: exp underflows, every
  gradient stays finite).  Within 1e-5 of each gradient's largest entry.
* ``loss_fn`` on reduced ``rwkv6-3b`` against ``jax.value_and_grad`` of
  the reference's, from the same weights and batch: the loss within 1e-5
  relative, every gradient within 2e-5 of its leaf's largest entry (the
  tolerances of ``test_torch_train_loss.py``); and with ``remat`` and
  ``loss_chunks=4`` the same loss and gradients as the plain call.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.data.pipeline import DataConfig as JxDataConfig
from repro.data.pipeline import make_batch as jx_make_batch
from repro.models import init_params as jx_init_params
from repro.models import loss_fn as jx_loss_fn
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.models import loss_fn
from repro_torch.tree import named_leaves

torch.set_num_threads(2)
WKV_TOL = 1e-5
LOSS_RTOL, GRAD_TOL = 1e-5, 2e-5


def _oracle(r, k, v, logw, u, s):
    """The recurrence, step by step, differentiable (f64)."""
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        outs.append(torch.einsum("bhi,bhij->bhj", rt, s)
                    + (rt * u * kt).sum(-1, keepdim=True) * vt)
        s = logw[:, t].exp()[..., None] * s + kt[..., :, None] * \
            vt[..., None, :]
    return torch.stack(outs, 1), s


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("t", [1, 5, 16, 37])
def test_wkv6_backward_matches_autograd_through_the_oracle(t, extreme):
    g = torch.Generator().manual_seed(t)
    b, h, hd = 2, 3, 8
    f64 = torch.float64

    def rand(*shape):
        return torch.randn(shape, generator=g, dtype=f64)

    r, k, v = rand(b, t, h, hd), rand(b, t, h, hd), rand(b, t, h, hd)
    logw = -torch.exp(rand(b, t, h, hd))
    if extreme:
        logw[:, t // 2] = -60.0
    u, s0 = rand(h, hd), rand(b, h, hd, hd)
    do, ds = rand(b, t, h, hd), rand(b, h, hd, hd)
    ins = [a.clone().requires_grad_() for a in (r, k, v, logw, u, s0)]
    o, s = _oracle(*ins)
    want = torch.autograd.grad((o * do).sum() + (s * ds).sum(), ins)
    ins32 = [a.float().requires_grad_() for a in (r, k, v, logw, u, s0)]
    o32, s32 = kernels.wkv6(*ins32)
    got = torch.autograd.grad((o32 * do.float()).sum()
                              + (s32 * ds.float()).sum(), ins32)
    for name, w, x in zip(("r", "k", "v", "logw", "u", "s0"), want, got):
        assert torch.isfinite(x).all(), name
        scale = max(float(w.abs().max()), 1.0)
        err = float((x.double() - w).abs().max())
        assert err <= WKV_TOL * scale, (name, err, scale)


def _setup():
    jcfg = jx_reduced(jx_get_config("rwkv6-3b"))
    cfg = reduced(get_config("rwkv6-3b"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    batch = jx_make_batch(JxDataConfig(seed=0, batch=2, seq_len=20,
                                       vocab_size=jcfg.vocab_size), 3, jcfg)
    return jcfg, cfg, jparams, params, batch


def _grads(params, batch, cfg, **kw):
    leaves = dict(named_leaves(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(params, batch, cfg, **kw)
    loss.backward()
    return loss.item(), {k: leaf.grad.clone() for k, leaf in leaves.items()}


def test_rwkv_loss_and_grads_match_the_reference():
    jcfg, cfg, jparams, params, batch = _setup()
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jx_loss_fn(p, batch, jcfg, remat=False),
        has_aux=True)(jparams)
    want = dict(named_leaves(bridge.params_from_jax(
        jax.tree.map(np.asarray, jgrads), cfg, device="cpu")))
    loss, grads = _grads(params, batch, cfg, remat=False)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert set(grads) == set(want)
    for key, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        err = float((grads[key] - w).abs().max())
        assert err <= GRAD_TOL * scale, (key, err, scale)
    for kw in (dict(remat=True), dict(remat=False, loss_chunks=4)):
        loss2, grads2 = _grads(params, batch, cfg, **kw)
        assert abs(loss2 - loss) <= LOSS_RTOL * abs(loss), kw
        for key, g in grads.items():
            scale = max(float(g.abs().max()), 1e-6)
            assert float((grads2[key] - g).abs().max()) <= GRAD_TOL * scale
