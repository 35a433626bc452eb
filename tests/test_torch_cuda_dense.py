"""The kernels at the new configs' shapes and options, on the card.

Marked ``cuda``: each test skips without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda_dense.py

* the three decode entries with ``window`` and ``softcap`` at hd 128 and
  GQA groups 1 (CodeQwen, GPT-2's width), 2 (Gemma-2) and 6 (InternLM2),
  with one split and with several (a window that starts inside a split,
  splits wholly before it), lengths below, at and past the window, and
  lengths past T, where the window starts from the given length;
* ``flash_attention`` non-causal (the encoders' prefill, also with a
  ``kv_len`` short of T) and windowed with a softcap at hd 128;
* ``rmsnorm_matmul`` and ``residual_rmsnorm`` at the new widths D 2048,
  4096, 4608 and 6144.

Tolerance as in ``test_torch_cuda_kernels.py``: the largest absolute error
at most 2e-5 (f32) or 2e-2 (bf16) times max(1, max |plain|).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.inference.kv_quant import quantize_kv
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_quant_ref,
    paged_decode_attention_ref)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused.residual_rmsnorm.ref import residual_rmsnorm_ref
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref

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


def _randn(shape, dtype, dev, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    bound = TOL[dtype] * max(1.0, ref.float().abs().max().item())
    assert err <= bound, (err, bound)


def _table(b, nb, n_pages, seed, dev):
    perm = np.random.default_rng(seed).permutation(n_pages)[:b * nb]
    return torch.from_numpy(perm.reshape(b, nb).astype(np.int32)).to(dev)


# (B, HQ, HKV, T): groups 1, 2 and 6 at hd 128; T 128 is one split, T 1024
# at batch 4 several (split_plan)
SHAPES = [(4, 32, 32, 128), (4, 32, 16, 128), (4, 48, 8, 128),
          (4, 32, 16, 1024), (2, 48, 8, 1024)]
OPTS = [(16, 50.0), (256, 50.0), (0, 30.0), (100, 0.0)]


@pytest.mark.parametrize("window,cap", OPTS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_entries_with_window_and_softcap(dev, shape, window, cap,
                                                dtype):
    b, hq, hkv, t = shape
    hd, bs = 128, 16
    nb = t // bs
    q = _randn((b, hq, hd), dtype, dev, 0)
    k = _randn((b, t, hkv, hd), dtype, dev, 1)
    v = _randn((b, t, hkv, hd), dtype, dev, 2)
    lens = torch.tensor(([t, t * 3 // 4, 17, 1] * b)[:b], dtype=torch.int32,
                        device=dev)
    opts = dict(scale=0.0625, window=window, softcap=cap)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    n0 = kernels.decode_attention.launches
    _close(kernels.decode_attention(q, kt, vt, lens, **opts),
           decode_attention_ref(q, kt, vt, lens, **opts), dtype)
    assert kernels.decode_attention.launches == n0 + 1
    n_pages = b * nb
    bt = _table(b, nb, n_pages, 3, dev)
    kp = torch.empty((n_pages, bs, hkv, hd), dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[bt.long().reshape(-1)] = k.reshape(b * nb, bs, hkv, hd)
    vp[bt.long().reshape(-1)] = v.reshape(b * nb, bs, hkv, hd)
    paged = kernels.paged_decode_attention(q, kp, vp, bt, lens, **opts)
    _close(paged, paged_decode_attention_ref(q, kp, vp, bt, lens, **opts),
           dtype)
    kq, ks = quantize_kv(kp.float())
    vq, vs = quantize_kv(vp.float())
    _close(kernels.paged_decode_attention_quant(q, kq, vq, ks, vs, bt, lens,
                                                **opts),
           paged_decode_attention_quant_ref(q, kq, vq, ks, vs, bt, lens,
                                            **opts), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_window_cuts_splits(dev, dtype):
    """Several splits a row; windows that end inside the first split, at a
    split's edge and inside later ones: the splits before the window keep
    the neutral partial and the merge stays bit-identical on repeats."""
    b, hq, hkv, t, hd = 4, 32, 16, 1024, 128
    n_split, per = da_ops.split_plan(t, b, hkv)
    assert n_split > 2
    q = _randn((b, hq, hd), dtype, dev, 4)
    k = _randn((b, hkv, t, hd), dtype, dev, 5)
    v = _randn((b, hkv, t, hd), dtype, dev, 6)
    lens = torch.tensor([t, per * 2, per + 3, 1000], dtype=torch.int32,
                        device=dev)
    for window in (1, 5, per, per + 1, 3 * per - 7):
        opts = dict(scale=0.0625, window=window, softcap=50.0)
        out = kernels.decode_attention(q, k, v, lens, **opts)
        _close(out, decode_attention_ref(q, k, v, lens, **opts), dtype)
        assert torch.equal(out, kernels.decode_attention(q, k, v, lens,
                                                         **opts))


@pytest.mark.parametrize("window", [16, 100])
@pytest.mark.parametrize("t", [128, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_window_from_a_length_past_t(dev, t, window, dtype):
    """kv_len > T with a window: the window starts at kv_len - window, not
    at the clamped length's, so a row keeps fewer than ``window`` positions
    or none (then it softmaxes uniformly), as the plain versions do."""
    b, hq, hkv, hd, bs = 4, 48, 8, 128, 16
    nb = t // bs
    q = _randn((b, hq, hd), dtype, dev, 7)
    k = _randn((b, t, hkv, hd), dtype, dev, 8)
    v = _randn((b, t, hkv, hd), dtype, dev, 9)
    lens = torch.tensor([t + 5, t + window - 1, t + window, t + 3 * window],
                        dtype=torch.int32, device=dev)
    opts = dict(scale=0.0625, window=window, softcap=50.0)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    _close(kernels.decode_attention(q, kt, vt, lens, **opts),
           decode_attention_ref(q, kt, vt, lens, **opts), dtype)
    bt = _table(b, nb, b * nb, 10, dev)
    kp = torch.empty((b * nb, bs, hkv, hd), dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[bt.long().reshape(-1)] = k.reshape(b * nb, bs, hkv, hd)
    vp[bt.long().reshape(-1)] = v.reshape(b * nb, bs, hkv, hd)
    _close(kernels.paged_decode_attention(q, kp, vp, bt, lens, **opts),
           paged_decode_attention_ref(q, kp, vp, bt, lens, **opts), dtype)
    kq, ks = quantize_kv(kp.float())
    vq, vs = quantize_kv(vp.float())
    _close(kernels.paged_decode_attention_quant(q, kq, vq, ks, vs, bt, lens,
                                                **opts),
           paged_decode_attention_quant_ref(q, kq, vq, ks, vs, bt, lens,
                                            **opts), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_wrappers_refuse_a_negative_window(dev, dtype):
    q = _randn((1, 4, 64), dtype, dev, 0)
    k = _randn((1, 4, 16, 64), dtype, dev, 1)
    with pytest.raises(ValueError, match="window"):
        kernels.decode_attention(q, k, k, 16, scale=0.1, window=-2)


@pytest.mark.parametrize("b,hq,hkv,s,t,hd,kv_len", [
    (4, 12, 12, 512, 512, 64, None),   # BERT's prefill at the paper's 512
    (1, 12, 12, 16, 16, 64, 11),       # a padded 11-token prompt
    (2, 4, 2, 40, 72, 32, 60)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_non_causal(dev, b, hq, hkv, s, t, hd, kv_len,
                                    dtype):
    q = _randn((b, hq, s, hd), dtype, dev, 0)
    k = _randn((b, t, hkv, hd), dtype, dev, 1).transpose(1, 2)
    v = _randn((b, t, hkv, hd), dtype, dev, 2).transpose(1, 2)
    scale = hd ** -0.5
    _close(kernels.flash_attention(q, k, v, kv_len, scale=scale,
                                   causal=False),
           attention_ref(q, k, v, kv_len, scale=scale, causal=False), dtype)


@pytest.mark.parametrize("s,window", [(16, 8), (128, 64), (300, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_window_and_softcap_hd128(dev, s, window, dtype):
    """Gemma-2's prefill: 32 / 16 heads of 128, a local window and the
    softcap of 50."""
    q = _randn((1, 32, s, 128), dtype, dev, 3)
    k = _randn((1, s, 16, 128), dtype, dev, 4).transpose(1, 2)
    v = _randn((1, s, 16, 128), dtype, dev, 5).transpose(1, 2)
    opts = dict(scale=0.0625, window=window, softcap=50.0)
    _close(kernels.flash_attention(q, k, v, **opts),
           attention_ref(q, k, v, **opts), dtype)


WIDTHS = [(2048, 2048), (4096, 4096), (4608, 4096), (6144, 6144)]


@pytest.mark.parametrize("d,f", WIDTHS)
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_at_the_new_widths(dev, d, f, n, dtype):
    x = _randn((n, d), dtype, dev, 0)
    w = _randn((d,), dtype, dev, 1) + 1.0
    r = _randn((n, d), dtype, dev, 2)
    p = _randn((d, f), dtype, dev, 3, scale=d ** -0.5)
    y, normed = kernels.rmsnorm_matmul(x, w, p)
    y_ref, normed_ref = rmsnorm_matmul_ref(x, w, p)
    _close(normed, normed_ref, dtype)
    _close(y, y_ref, dtype)
    for res in (r, None):
        out, total = kernels.residual_rmsnorm(x, w, res)
        out_ref, total_ref = residual_rmsnorm_ref(x, w, res)
        _close(out, out_ref, dtype)
        _close(total, total_ref, dtype)
