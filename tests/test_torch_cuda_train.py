"""Training on the card: the backward rules of the custom ops and one
full-width SmolLM-360M training step.

Marked ``cuda``: each test skips without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \\
        tests/test_torch_cuda_train.py

* each registered backward (``kernels/*/backward.py``) with the CUDA
  kernel's forward, against ``torch.autograd`` through the op's plain
  version (``ref.py``) on the same inputs, in f32 (TF32 off) and bf16:
  flash attention causal, non-causal with S != T, with a window, a soft
  cap and GQA groups 1 and 3; the norms with and without a residual;
  ``rmsnorm_matmul`` with each output's gradient.  Each gradient within
  2e-5 (f32) or 2e-2 (bf16) times max(1, max |plain|);
* one training step of whole SmolLM-360M (bf16 parameters, f32 AdamW
  state) at batch 8 x 512: finite loss and gradients, and the forward
  launches rmsnorm_matmul 32, residual_rmsnorm 33 and flash_attention 32
  times.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_batch
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused.residual_rmsnorm.ref import \
    residual_rmsnorm_ref
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref
from repro_torch.models import init_params, loss_fn
from repro_torch.training.loop import to_device
from repro_torch.training.optim import OptConfig, opt_init, opt_update
from repro_torch.tree import leaves, map_tree

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed, scale=1.0, grad=True):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype) \
        .requires_grad_(grad)


def _grads(fn, ins, gouts):
    outs = fn(*ins)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, gouts) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], ins,
                               [g for _, g in pairs], allow_unused=True)


def _close(got, want, dtype, what):
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None or not g.any(), (what, i)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        err = (g.float() - w.float()).abs().max().item()
        tol = TOL[dtype] * max(1.0, w.float().abs().max().item())
        assert err <= tol, (what, i, err, tol)


# (B, hq, hkv, S, T, hd, causal, window, softcap)
FLASH = {
    "smollm_train": (2, 15, 5, 512, 512, 64, True, 0, 0.0),
    "gqa1_window_softcap": (2, 8, 8, 256, 256, 128, True, 64, 50.0),
    "noncausal_s_lt_t": (2, 6, 2, 16, 300, 64, False, 0, 0.0),
    "noncausal_s_gt_t": (1, 16, 16, 16, 1, 64, False, 0, 0.0),
    "prefill_offset": (2, 6, 2, 100, 228, 64, True, 0, 0.0),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_backward(dev, case, dtype):
    b, hq, hkv, s, t, hd, causal, window, cap = FLASH[case]
    q = _randn((b, hq, s, hd), dtype, dev, 1)
    k = _randn((b, hkv, t, hd), dtype, dev, 2)
    v = _randn((b, hkv, t, hd), dtype, dev, 3)
    go = _randn((b, s, hq, hd), dtype, dev, 4, grad=False).transpose(1, 2)
    opts = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
    n0 = kernels.flash_attention.launches
    got = _grads(lambda *a: kernels.flash_attention(*a, **opts), (q, k, v),
                 (go,))
    assert kernels.flash_attention.launches == n0 + 1
    want = _grads(lambda *a: attention_ref(*a, **opts), (q, k, v), (go,))
    _close(got, want, dtype, case)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("wrapper", ["residual_rmsnorm", "rmsnorm"])
@pytest.mark.parametrize("residual", [False, True])
def test_norm_backward(dev, wrapper, residual, dtype):
    x, w = _randn((8, 512, 960), dtype, dev, 5), _randn((960,), dtype, dev, 6)
    r = _randn((8, 512, 960), dtype, dev, 7, 0.5) if residual else None
    ins = (x, w) if r is None else (x, w, r)
    gy = _randn((8, 512, 960), dtype, dev, 8, grad=False)
    gs = _randn((8, 512, 960), dtype, dev, 9, grad=False) if residual \
        else None
    fn = getattr(kernels, wrapper)
    n0 = fn.launches
    got = _grads(lambda x, w, r=None: fn(x, w, r), ins, (gy, gs))
    assert fn.launches == n0 + 1
    want = _grads(lambda x, w, r=None: residual_rmsnorm_ref(x, w, r), ins,
                  (gy, gs))
    _close(got, want, dtype, (wrapper, residual))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("outputs", ["both", "proj", "normed"])
def test_rmsnorm_matmul_backward(dev, outputs, dtype):
    x, w = _randn((8, 512, 960), dtype, dev, 10), \
        _randn((960,), dtype, dev, 11)
    wp = _randn((960, 960), dtype, dev, 12, 0.03)
    gp = _randn((8, 512, 960), dtype, dev, 13, grad=False)
    gn = _randn((8, 512, 960), dtype, dev, 14, grad=False)
    gouts = {"both": (gp, gn), "proj": (gp, None),
             "normed": (None, gn)}[outputs]
    got = _grads(lambda *a: kernels.rmsnorm_matmul(*a), (x, w, wp), gouts)
    want = _grads(lambda *a: rmsnorm_matmul_ref(*a), (x, w, wp), gouts)
    _close(got, want, dtype, outputs)


def test_smollm_full_width_training_step(dev):
    cfg = get_config("smollm-360m")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    state = opt_init(oc, params)
    batch = to_device(make_batch(DataConfig(batch=8, seq_len=512,
                                            vocab_size=cfg.vocab_size), 0),
                      dev)
    kernels.reset_launch_counts()
    loss, (ce, aux) = loss_fn(params, batch, cfg, remat=False)
    counts = kernels.launch_counts()
    assert (counts["rmsnorm_matmul"], counts["residual_rmsnorm"],
            counts["flash_attention"]) == (32, 33, 32)
    loss.backward()
    assert kernels.launch_counts() == counts     # the backward is torch ops
    assert math.isfinite(loss.item()) and abs(ce.item() - math.log(
        cfg.vocab_size)) < 1.0 and aux.item() == 0.0
    grads = map_tree(lambda p: p.grad, params)
    for g in leaves(grads):
        assert g is not None and bool(torch.isfinite(g).all())
    before = params["blocks"][0]["mixer"]["wq"].detach().clone()
    opt_update(oc, grads, state, params)
    assert int(state["step"]) == 1
    assert not torch.equal(before, params["blocks"][0]["mixer"]["wq"])
