"""The autograd rules of the port's custom ops on the training path
(``kernels/*/backward.py``) against ``torch.autograd`` through each op's
plain version (``ref.py``), on the CPU, where the ops' forwards are those
plain versions.

``ref.py`` computes in f32 whatever its inputs, so the two sides are held
in f32: within TOL of the largest entry of each gradient (the two sum in
other orders; they part by about 1e-7).  The cases cover causal,
non-causal with S != T, a window, a soft cap (and both), a kv_len bound,
a row that every key is masked from, GQA groups 1 and 3, an output
gradient with the strides of the kernel's token-major output, the norms
with and without a residual, and either output of ``rmsnorm_matmul``
alone.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused.residual_rmsnorm.ref import \
    residual_rmsnorm_ref
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref

torch.set_num_threads(2)
TOL = 1e-5


def _t(seed, shape, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).requires_grad_(True)


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        err = (g - w).abs().max().item()
        assert err <= TOL * max(1.0, w.abs().max().item()), (what, i, err)


# (hq, hkv, S, T, causal, window, softcap, kv_len)
FLASH = {
    "causal": (4, 4, 12, 12, True, 0, 0.0, None),
    "causal_gqa3": (6, 2, 12, 12, True, 0, 0.0, None),
    "noncausal_s_lt_t": (6, 2, 5, 17, False, 0, 0.0, None),
    "noncausal_s_gt_t": (3, 1, 16, 1, False, 0, 0.0, None),
    "prefill_offset": (4, 2, 6, 14, True, 0, 0.0, None),
    "window": (6, 2, 16, 16, True, 5, 0.0, None),
    "softcap": (4, 4, 10, 10, True, 0, 2.0, None),
    "window_softcap": (6, 2, 16, 16, True, 4, 1.5, None),
    "kv_len": (4, 2, 4, 12, True, 0, 0.0, 9),
    "masked_row": (2, 2, 3, 8, True, 0, 0.0, 0),
}


@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_backward_matches_autograd(case):
    hq, hkv, s, t, causal, window, cap, kv_len = FLASH[case]
    q, k, v = _t(1, (2, hq, s, 16)), _t(2, (2, hkv, t, 16)), \
        _t(3, (2, hkv, t, 16))
    # the card's output is a view of a token-major buffer: so is dO here
    go = _t(4, (2, s, hq, 16)).detach().transpose(1, 2)
    opts = dict(scale=0.3, causal=causal, window=window, softcap=cap)
    got = torch.autograd.grad(kernels.flash_attention(q, k, v, kv_len,
                                                      **opts), (q, k, v), go)
    want = torch.autograd.grad(attention_ref(q, k, v, kv_len, **opts),
                               (q, k, v), go)
    _close(got, want, case)


@pytest.mark.parametrize("wrapper", ["residual_rmsnorm", "rmsnorm"])
@pytest.mark.parametrize("residual", [False, True])
def test_norm_backward_matches_autograd(wrapper, residual):
    x, w = _t(5, (3, 4, 32)), _t(6, (32,))
    r = _t(7, (3, 4, 32)) if residual else None
    ga, gb = _t(8, (3, 4, 32)).detach(), _t(9, (3, 4, 32)).detach()
    ins = (x, w) if r is None else (x, w, r)

    def loss(out):
        return (out[0] * ga).sum() + (out[1] * gb).sum()
    got = torch.autograd.grad(loss(getattr(kernels, wrapper)(x, w, r)), ins)
    want = torch.autograd.grad(loss(residual_rmsnorm_ref(x, w, r)), ins)
    _close(got, want, (wrapper, residual))
    # the normed output alone (the sum output unused)
    got = torch.autograd.grad(
        (getattr(kernels, wrapper)(x, w, r)[0] * ga).sum(), ins)
    want = torch.autograd.grad((residual_rmsnorm_ref(x, w, r)[0] * ga).sum(),
                               ins)
    _close(got, want, (wrapper, residual, "normed only"))


@pytest.mark.parametrize("outputs", ["both", "proj", "normed"])
def test_rmsnorm_matmul_backward_matches_autograd(outputs):
    x, w, wp = _t(10, (2, 5, 48)), _t(11, (48,)), _t(12, (48, 40), 0.2)
    gp, gn = _t(13, (2, 5, 40)).detach(), _t(14, (2, 5, 48)).detach()

    def loss(out):
        proj, normed = out
        terms = {"proj": (proj * gp).sum(), "normed": (normed * gn).sum()}
        return sum(terms.values()) if outputs == "both" else terms[outputs]
    got = torch.autograd.grad(loss(kernels.rmsnorm_matmul(x, w, wp)),
                              (x, w, wp), allow_unused=True)
    want = torch.autograd.grad(loss(rmsnorm_matmul_ref(x, w, wp)),
                               (x, w, wp), allow_unused=True)
    if outputs == "normed":
        assert got[2] is None and want[2] is None
        got, want = got[:2], want[:2]
    _close(got, want, outputs)


def test_backward_keeps_bf16():
    q = _t(15, (1, 4, 8, 16)).detach().bfloat16().requires_grad_(True)
    k = _t(16, (1, 2, 8, 16)).detach().bfloat16().requires_grad_(True)
    o = kernels.flash_attention(q, k, k, scale=0.25)
    dq, dk = torch.autograd.grad(o.float().sum(), (q, k))
    assert dq.dtype == dk.dtype == torch.bfloat16
    x = _t(17, (3, 32)).detach().bfloat16().requires_grad_(True)
    w = torch.ones(32, dtype=torch.bfloat16, requires_grad=True)
    wp = _t(18, (32, 8)).detach().bfloat16().requires_grad_(True)
    grads = torch.autograd.grad(kernels.rmsnorm_matmul(x, w, wp)[0].sum(),
                                (x, w, wp))
    assert all(g.dtype == torch.bfloat16 for g in grads)
