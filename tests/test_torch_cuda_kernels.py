"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU.  On a machine with one (and
without JAX, so without this directory's conftest):

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda_kernels.py

Shapes follow the reference's kernel tests (head dims 16, 32, 64 and 112,
GQA groups 1-4) plus the SmolLM-360M main-path shapes.  Tolerance: the
largest absolute error at most 2e-5 (f32) or 2e-2 (bf16) times
max(1, max |plain|); TF32 is off, so the plain f32 products are exact f32.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
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


@pytest.mark.parametrize("shape", [
    (2, 4, 2, 64, 64, 32), (1, 6, 2, 37, 37, 16), (2, 8, 8, 128, 256, 64),
    (1, 4, 1, 33, 65, 112), (1, 15, 5, 16, 16, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention(dev, shape, dtype):
    b, hq, hkv, s, t, hd = shape
    q = _randn((b, hq, s, hd), dtype, dev, 0)
    # K/V as the transposed view of a token-major buffer, as prefill passes
    k = _randn((b, t, hkv, hd), dtype, dev, 1).transpose(1, 2)
    v = _randn((b, t, hkv, hd), dtype, dev, 2).transpose(1, 2)
    n0 = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, scale=0.2)
    assert kernels.flash_attention.launches == n0 + 1
    _close(out, attention_ref(q, k, v, scale=0.2), dtype)


@pytest.mark.parametrize("window,cap,kv_len", [
    (16, 0.0, None), (0, 8.0, None), (16, 8.0, 40), (0, 0.0, 3)])
def test_flash_attention_masks(dev, window, cap, kv_len):
    b, hq, hkv, s, t, hd = 1, 4, 2, 64, 64, 32
    q = _randn((b, hq, s, hd), torch.float32, dev, 3)
    k = _randn((b, hkv, t, hd), torch.float32, dev, 4)
    v = _randn((b, hkv, t, hd), torch.float32, dev, 5)
    kw = dict(scale=0.2, causal=True, window=window, softcap=cap)
    _close(kernels.flash_attention(q, k, v, kv_len, **kw),
           attention_ref(q, k, v, kv_len, **kw), torch.float32)


def test_flash_attention_fully_masked_rows(dev):
    # S > T puts the first queries before every key: those rows have no
    # valid key and must softmax NEG_INF uniformly, as the plain version
    q = _randn((1, 2, 40, 16), torch.float32, dev, 6)
    k = _randn((1, 1, 24, 16), torch.float32, dev, 7)
    v = _randn((1, 1, 24, 16), torch.float32, dev, 8)
    _close(kernels.flash_attention(q, k, v, scale=0.25),
           attention_ref(q, k, v, scale=0.25), torch.float32)


@pytest.mark.parametrize("shape", [(2, 4, 2, 128, 32), (1, 8, 8, 500, 64),
                                   (3, 6, 3, 96, 16), (4, 15, 5, 128, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention(dev, shape, dtype):
    b, hq, hkv, t, hd = shape
    q = _randn((b, hq, hd), dtype, dev, 0)
    k = _randn((b, hkv, t, hd), dtype, dev, 1)
    v = _randn((b, hkv, t, hd), dtype, dev, 2)
    for kv_len in (None, t, t // 2, 5, 0):
        _close(kernels.decode_attention(q, k, v, kv_len, scale=0.2),
               decode_attention_ref(q, k, v, kv_len, scale=0.2), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_per_row_strided_cache(dev, dtype):
    b, hq, hkv, t, hd = 4, 15, 5, 128, 64
    q = _randn((b, hq, hd), dtype, dev, 0)
    cache_k = _randn((b, t, hkv, hd), dtype, dev, 1)    # engine layout
    cache_v = _randn((b, t, hkv, hd), dtype, dev, 2)
    lens = torch.tensor([1, 17, 128, 200], dtype=torch.int32, device=dev)
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    n0 = kernels.decode_attention.launches
    out = kernels.decode_attention(q, k, v, lens, scale=0.125)
    assert kernels.decode_attention.launches == n0 + 1
    _close(out, decode_attention_ref(q, k, v, lens, scale=0.125), dtype)


@pytest.mark.parametrize("n,d", [(1, 64), (6, 32), (5, 128), (4, 960),
                                 (16, 960)])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_rmsnorm(dev, n, d, with_res, dtype):
    x = _randn((n, d), dtype, dev, 0)
    w = _randn((d,), dtype, dev, 1) + 1.0
    r = _randn((n, d), dtype, dev, 2) if with_res else None
    y, s = kernels.residual_rmsnorm(x, w, r)
    y_ref, s_ref = residual_rmsnorm_ref(x, w, r)
    _close(y, y_ref, dtype)
    _close(s, s_ref, dtype)
    if not with_res:
        assert s is x


@pytest.mark.parametrize("n,d,f", [(1, 64, 128), (7, 32, 48), (16, 64, 64),
                                   (20, 96, 100), (4, 960, 960),
                                   (16, 960, 960)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matmul(dev, n, d, f, dtype):
    x = _randn((n, d), dtype, dev, 0)
    w = _randn((d,), dtype, dev, 1)
    p = _randn((d, f), dtype, dev, 2, scale=d ** -0.5)
    n0 = kernels.rmsnorm_matmul.launches
    y, normed = kernels.rmsnorm_matmul(x, w, p)
    assert kernels.rmsnorm_matmul.launches == n0 + 1
    y_ref, normed_ref = rmsnorm_matmul_ref(x, w, p)
    _close(normed, normed_ref, dtype)
    _close(y, y_ref, dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _randn((4, 64), torch.float16, dev, 0)
    with pytest.raises(TypeError):
        kernels.residual_rmsnorm(x, torch.ones(64, dtype=x.dtype, device=dev))
    q = _randn((1, 4, 256), torch.float32, dev, 0)
    k = _randn((1, 2, 8, 256), torch.float32, dev, 1)
    with pytest.raises(ValueError):
        kernels.decode_attention(q, k, k, scale=1.0)
    with pytest.raises(ValueError):   # mixed devices
        kernels.rmsnorm_matmul(x.float(), torch.ones(64, device=dev),
                               torch.ones(64, 8))
