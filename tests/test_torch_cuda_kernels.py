"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU.  On a machine with one (and
without JAX, so without this directory's conftest):

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda_kernels.py

Shapes follow the reference's kernel tests (head dims 16, 32, 64 and 112,
GQA groups 1-4; the paged kernels on the grid of the reference's paged
tests; WKV6 on its grid and extreme-decay case) plus the SmolLM-360M and
RWKV-6 3B main-path shapes, and each path inside a kernel: flash attention
at GQA groups up to 8, head dims that are not multiples of 16 or 8,
several key tiles with masks, unaligned rows (scalar loads); the norms at
widths with a scalar tail, wider than a warp holds, and unaligned.  Tolerance: the
largest absolute error at most 2e-5 (f32) or 2e-2 (bf16) times
max(1, max |plain|); TF32 is off, so the plain f32 products are exact f32.
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
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rwkv6.ref import wkv6_oracle, wkv6_ref

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
    (1, 4, 1, 33, 65, 112), (1, 15, 5, 16, 16, 64),
    # the smoke run's t128 and full-width t1024 prefill
    (1, 15, 5, 128, 128, 64), (1, 15, 5, 1024, 1024, 64),
    # GQA groups 1, 2, 3 and 8; S not a multiple of 16; S > T
    (1, 4, 4, 40, 72, 64), (2, 4, 2, 33, 33, 32), (1, 9, 3, 21, 100, 64),
    (1, 8, 1, 70, 70, 64), (1, 4, 2, 50, 30, 32),
    # hd % 16 != 0 (a zero-padded k-step) and hd % 8 != 0 (scalar loads)
    (1, 6, 3, 45, 45, 40), (1, 4, 2, 19, 19, 20)])
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
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_masks(dev, window, cap, kv_len, dtype):
    b, hq, hkv, s, t, hd = 1, 4, 2, 64, 64, 32
    q = _randn((b, hq, s, hd), dtype, dev, 3)
    k = _randn((b, hkv, t, hd), dtype, dev, 4)
    v = _randn((b, hkv, t, hd), dtype, dev, 5)
    kw = dict(scale=0.2, causal=True, window=window, softcap=cap)
    _close(kernels.flash_attention(q, k, v, kv_len, **kw),
           attention_ref(q, k, v, kv_len, **kw), dtype)


@pytest.mark.parametrize("window,kv_len", [(0, None), (48, 100), (0, 70)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_masks_long(dev, window, kv_len, dtype):
    """Several 64-key tiles: windowed and kv_len-cut rows skip whole tiles
    and mask only the boundary ones."""
    b, hq, hkv, s, t, hd = 1, 6, 2, 200, 200, 64
    q = _randn((b, hq, s, hd), dtype, dev, 9)
    k = _randn((b, t, hkv, hd), dtype, dev, 10).transpose(1, 2)
    v = _randn((b, t, hkv, hd), dtype, dev, 11).transpose(1, 2)
    kw = dict(scale=0.125, causal=True, window=window)
    _close(kernels.flash_attention(q, k, v, kv_len, **kw),
           attention_ref(q, k, v, kv_len, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_fully_masked_rows(dev, dtype):
    # S > T puts the first queries before every key: those rows have no
    # valid key and must softmax NEG_INF uniformly, as the plain version
    q = _randn((1, 2, 40, 16), dtype, dev, 6)
    k = _randn((1, 1, 24, 16), dtype, dev, 7)
    v = _randn((1, 1, 24, 16), dtype, dev, 8)
    _close(kernels.flash_attention(q, k, v, scale=0.25),
           attention_ref(q, k, v, scale=0.25), dtype)


def _offset_view(shape, dtype, dev, seed):
    """A contiguous tensor one element past a 16-byte boundary."""
    flat = _randn((int(np.prod(shape)) + 1,), dtype, dev, seed)
    return flat[1:].view(shape)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_unaligned_rows(dev, dtype):
    """Q and K rows that do not start on a 16-byte boundary take the
    kernel's scalar loads."""
    b, hq, hkv, s, t, hd = 1, 6, 2, 24, 40, 64
    q = _offset_view((b, hq, s, hd), dtype, dev, 12)
    k = _offset_view((b, hkv, t, hd), dtype, dev, 13)
    v = _randn((b, hkv, t, hd), dtype, dev, 14)
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    n0 = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, scale=0.125)
    assert kernels.flash_attention.launches == n0 + 1
    _close(out, attention_ref(q, k, v, scale=0.125), dtype)


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


def _paged_pool(b, hkv, t, hd, bs, dtype, dev, seed, fused_kv=False):
    """Permuted pages holding B rows of T positions, a pool twice the size
    needed, unused table entries a sentinel past the pool.  ``fused_kv``
    stores K and V in one (P, bs, 2, HKV, hd) buffer, so each pool is a
    strided view."""
    n_pages = 2 * (b * t // bs)
    shape = (n_pages, bs, 2, hkv, hd) if fused_kv else (n_pages, bs, hkv, hd)
    if fused_kv:
        buf = _randn(shape, dtype, dev, seed)
        kp, vp = buf[:, :, 0], buf[:, :, 1]
    else:
        kp = _randn(shape, dtype, dev, seed)
        vp = _randn(shape, dtype, dev, seed + 1)
    perm = np.random.default_rng(seed).permutation(n_pages)
    tables = np.full((b, t // bs), n_pages + 3, np.int32)
    lens = np.array([t - 3 * i for i in range(b)], np.int32)
    nxt = 0
    for row in range(b):
        for i in range(-(-int(lens[row]) // bs)):
            tables[row, i] = perm[nxt]
            nxt += 1
    return (kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev))


PAGED_GRID = [((2, 6, 2, 32, 32), 8), ((1, 4, 4, 64, 16), 16),
              ((3, 8, 2, 128, 64), 32), ((4, 15, 5, 128, 64), 16)]


@pytest.mark.parametrize("shape,bs", PAGED_GRID)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused_kv", [False, True])
def test_paged_decode_attention(dev, shape, bs, dtype, fused_kv):
    b, hq, hkv, t, hd = shape
    q = _randn((b, hq, hd), dtype, dev, 0)
    kp, vp, tables, lens = _paged_pool(b, hkv, t, hd, bs, dtype, dev, 1,
                                       fused_kv)
    n0 = kernels.paged_decode_attention.launches
    out = kernels.paged_decode_attention(q, kp, vp, tables, lens, scale=0.2)
    assert kernels.paged_decode_attention.launches == n0 + 1
    _close(out, paged_decode_attention_ref(q, kp, vp, tables, lens,
                                           scale=0.2), dtype)


@pytest.mark.parametrize("shape,bs", PAGED_GRID)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused_kv", [False, True])
def test_paged_decode_attention_quant(dev, shape, bs, dtype, fused_kv):
    b, hq, hkv, t, hd = shape
    q = _randn((b, hq, hd), dtype, dev, 0)
    kf, vf, tables, lens = _paged_pool(b, hkv, t, hd, bs, torch.float32,
                                       dev, 2, fused_kv)
    (kq, ks), (vq, vs) = quantize_kv(kf), quantize_kv(vf)
    if fused_kv:                  # int8 pools and scales as strided views
        kq = torch.stack([kq, vq], 2)[:, :, 0]
        ks = torch.stack([ks, vs], 2)[:, :, 0]
    n0 = kernels.paged_decode_attention_quant.launches
    out = kernels.paged_decode_attention(q, kq, vq, tables, lens, scale=0.2,
                                         k_scale=ks, v_scale=vs)
    assert kernels.paged_decode_attention_quant.launches == n0 + 1
    _close(out, paged_decode_attention_quant_ref(q, kq, vq, ks, vs, tables,
                                                 lens, scale=0.2), dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_sentinel_and_empty_rows(dev, quant):
    """A row of sentinels with kv_lens 0 softmaxes uniformly over the
    clamped pages, garbage past a row's length is never read, and lengths
    past NB*bs are capped, all as in the plain version."""
    b, hq, hkv, t, hd, bs = 4, 6, 2, 64, 32, 8
    q = _randn((b, hq, hd), torch.float32, dev, 0)
    kp, vp, tables, _ = _paged_pool(b, hkv, t, hd, bs, torch.float32, dev, 3)
    n_pages = kp.shape[0]
    tables[0] = n_pages                               # all sentinel
    tables[1, 2:] = torch.tensor([0, n_pages + 1000, -5, 7, 1, 2],
                                 dtype=torch.int32)   # garbage
    lens = torch.tensor([0, 13, 64, 500], dtype=torch.int32, device=dev)
    kw = dict(scale=0.2)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        out = kernels.paged_decode_attention_quant(q, kp, vp, ks, vs, tables,
                                                   lens, **kw)
        ref = paged_decode_attention_quant_ref(q, kp, vp, ks, vs, tables,
                                               lens, **kw)
    else:
        out = kernels.paged_decode_attention(q, kp, vp, tables, lens, **kw)
        ref = paged_decode_attention_ref(q, kp, vp, tables, lens, **kw)
    _close(out, ref, torch.float32)


def _paged_t1024(b, hkv, hd, lens, bs, dtype, dev, seed):
    """A pool of b * 1024 / bs permuted pages, each row's table holding its
    pages and then sentinels past the pool."""
    nb = 1024 // bs
    n_pages = b * nb + 8
    kp = _randn((n_pages, bs, hkv, hd), dtype, dev, seed)
    vp = _randn((n_pages, bs, hkv, hd), dtype, dev, seed + 1)
    perm = np.random.default_rng(seed).permutation(n_pages)
    tables = np.full((b, nb), n_pages + 5, np.int32)
    nxt = 0
    for row, n in enumerate(lens):
        for i in range(-(-n // bs)):
            tables[row, i] = perm[nxt]
            nxt += 1
    return (kp, vp, torch.from_numpy(tables).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


T1024_LENS = [1024, 768, 512, 256]


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_t1024(dev, dtype):
    """The main path's heads over a 1024-position cache, split over
    positions (split_plan) and merged by the last CTA of each pair."""
    b, hq, hkv, t, hd = 4, 15, 5, 1024, 64
    assert da_ops.split_plan(t, b, hkv)[0] > 1
    q = _randn((b, hq, hd), dtype, dev, 0)
    k = _randn((b, t, hkv, hd), dtype, dev, 1).transpose(1, 2)
    v = _randn((b, t, hkv, hd), dtype, dev, 2).transpose(1, 2)
    lens = torch.tensor(T1024_LENS, dtype=torch.int32, device=dev)
    n0 = kernels.decode_attention.launches
    out = kernels.decode_attention(q, k, v, lens, scale=0.125)
    assert kernels.decode_attention.launches == n0 + 1
    _close(out, decode_attention_ref(q, k, v, lens, scale=0.125), dtype)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_t1024(dev, quant, dtype):
    b, hq, hkv, hd, bs = 4, 15, 5, 64, 16
    q = _randn((b, hq, hd), dtype, dev, 3)
    kp, vp, tables, lens = _paged_t1024(b, hkv, hd, T1024_LENS, bs,
                                        torch.float32 if quant else dtype,
                                        dev, 4)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        out = kernels.paged_decode_attention_quant(q, kp, vp, ks, vs, tables,
                                                   lens, scale=0.125)
        ref = paged_decode_attention_quant_ref(q, kp, vp, ks, vs, tables,
                                               lens, scale=0.125)
    else:
        out = kernels.paged_decode_attention(q, kp, vp, tables, lens,
                                             scale=0.125)
        ref = paged_decode_attention_ref(q, kp, vp, tables, lens,
                                         scale=0.125)
    _close(out, ref, dtype)


# (B, HQ, HKV, T, hd): GQA groups 1 and 8, head dims 20 and 128, several
# splits; lengths: masked (0), exactly one split's worth, one past it, all
SPLIT_GRID = [(4, 4, 4, 1024, 64), (2, 8, 1, 1024, 64), (3, 6, 3, 777, 20),
              (4, 8, 2, 1024, 128), (1, 16, 2, 2048, 128),
              (5, 3, 1, 600, 32)]


@pytest.mark.parametrize("shape", SPLIT_GRID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_many_splits_mixed_lengths(dev, shape, dtype):
    b, hq, hkv, t, hd = shape
    n_split, per = da_ops.split_plan(t, b, hkv)
    assert n_split > 1
    lens = [0, per, per + 1, t, t // 3][:b]
    lens += [t - 1] * (b - len(lens))
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _randn((b, hq, hd), dtype, dev, 5)
    k = _randn((b, t, hkv, hd), dtype, dev, 6).transpose(1, 2)
    v = _randn((b, t, hkv, hd), dtype, dev, 7).transpose(1, 2)
    _close(kernels.decode_attention(q, k, v, lens, scale=hd ** -0.5),
           decode_attention_ref(q, k, v, lens, scale=hd ** -0.5), dtype)
    bs = 16
    kp, vp, tables, _ = _paged_pool(b, hkv, t - t % bs, hd, bs, dtype, dev,
                                    8)
    lens_p = lens.clamp(max=t - t % bs)
    _close(kernels.paged_decode_attention(q, kp, vp, tables, lens_p,
                                          scale=hd ** -0.5),
           paged_decode_attention_ref(q, kp, vp, tables, lens_p,
                                      scale=hd ** -0.5), dtype)


@pytest.mark.parametrize("t", [128, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_ignores_what_lies_past_a_length(dev, t, dtype):
    """Cache rows at or past a row's length may hold anything, NaN too (a
    batch loads them and weighs them 0): the output equals the plain
    version's on a cache with those rows zeroed."""
    b, hq, hkv, hd = 4, 15, 5, 64
    q = _randn((b, hq, hd), dtype, dev, 17)
    k = _randn((b, t, hkv, hd), dtype, dev, 18)
    v = _randn((b, t, hkv, hd), dtype, dev, 19)
    lens = torch.tensor([1, t // 3, 5, t - 1], dtype=torch.int32, device=dev)
    past = (torch.arange(t, device=dev)[None, :]
            >= lens[:, None])[:, :, None, None]
    k_nan, v_nan = k.masked_fill(past, float("nan")), \
        v.masked_fill(past, float("nan"))
    out = kernels.decode_attention(q, k_nan.transpose(1, 2),
                                   v_nan.transpose(1, 2), lens, scale=0.125)
    ref = decode_attention_ref(q, k.masked_fill(past, 0).transpose(1, 2),
                               v.masked_fill(past, 0).transpose(1, 2), lens,
                               scale=0.125)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_unaligned_views(dev, dtype):
    """q, K and V one element into their buffers (element loads), with one
    split and with several."""
    for t in (128, 1024):
        b, hq, hkv, hd = 2, 6, 2, 64
        qb = _randn((b * hq * hd + 1,), dtype, dev, 9)
        kb = _randn((b * t * hkv * hd + 1,), dtype, dev, 10)
        vb = _randn((b * t * hkv * hd + 1,), dtype, dev, 11)
        q = qb[1:].view(b, hq, hd)
        k = kb[1:].view(b, t, hkv, hd).transpose(1, 2)
        v = vb[1:].view(b, t, hkv, hd).transpose(1, 2)
        lens = torch.tensor([t // 2, t - 3], dtype=torch.int32, device=dev)
        _close(kernels.decode_attention(q, k, v, lens, scale=0.125),
               decode_attention_ref(q, k, v, lens, scale=0.125), dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_repeats_bit_for_bit(dev, quant):
    """Three calls in a row give the same bits: each call's last CTA of a
    (row, KV head) leaves its counter at zero for the next."""
    b, hq, hkv, hd, bs = 4, 15, 5, 64, 16
    q = _randn((b, hq, hd), torch.bfloat16, dev, 12)
    kp, vp, tables, lens = _paged_t1024(b, hkv, hd, [1024, 0, 16, 500], bs,
                                        torch.float32 if quant
                                        else torch.bfloat16, dev, 13)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kw = {}
    runs = [kernels.paged_decode_attention(q, kp, vp, tables, lens,
                                           scale=0.125, **kw)
            for _ in range(3)]
    k = _randn((b, 1024, hkv, hd), torch.bfloat16, dev, 14).transpose(1, 2)
    runs_c = [kernels.decode_attention(q, k, k, lens, scale=0.125)
              for _ in range(3)]
    for rs in (runs, runs_c):
        assert all(torch.equal(r, rs[0]) for r in rs[1:])


def test_decode_attention_counters_per_stream(dev):
    """The split counters are kept per stream: the same call on a side
    stream and on the default one, interleaved, gives the same bits."""
    b, hq, hkv, t, hd = 4, 15, 5, 1024, 64
    q = _randn((b, hq, hd), torch.bfloat16, dev, 15)
    k = _randn((b, hkv, t, hd), torch.bfloat16, dev, 16)
    lens = torch.tensor(T1024_LENS, dtype=torch.int32, device=dev)
    want = kernels.decode_attention(q, k, k, lens, scale=0.125)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(4):
        with torch.cuda.stream(side):
            outs.append(kernels.decode_attention(q, k, k, lens, scale=0.125))
        outs.append(kernels.decode_attention(q, k, k, lens, scale=0.125))
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    assert len(da_ops._counters) >= 2


# widths with a scalar tail (100, 1001), the port's (960, 2560), many rows
# (1024 x 960) and a row wider than a warp holds (8192)
NORM_GRID = [(1, 64), (6, 32), (5, 128), (4, 960), (16, 960), (3, 100),
             (5, 1001), (1024, 960), (4, 2560), (12, 2560), (2, 8192)]


@pytest.mark.parametrize("n,d", NORM_GRID)
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


@pytest.mark.parametrize("n", list(range(1, 17)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matmul_rows_1_to_16(dev, n, dtype):
    """Every row count the main path sends at SmolLM's 960 x 960, in f32
    (FMA kernel: two groups of 8 rows over the held W tile, ragged last
    groups) and bf16 (one 16-row tensor-core tile, rows past N zero)."""
    x = _randn((n, 960), dtype, dev, 3)
    w = _randn((960,), dtype, dev, 4) + 1.0
    p = _randn((960, 960), dtype, dev, 5, scale=0.02)
    y, normed = kernels.rmsnorm_matmul(x, w, p)
    y_ref, normed_ref = rmsnorm_matmul_ref(x, w, p)
    _close(normed, normed_ref, dtype)
    _close(y, y_ref, dtype)


@pytest.mark.parametrize("n,d,f", [(4, 2560, 960), (16, 2560, 64),
                                   (4, 8192, 24), (12, 8192, 8),
                                   (40, 1025, 100), (33, 960, 960),
                                   (6, 968, 40), (3, 1001, 13), (5, 77, 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matmul_wide_and_ragged(dev, n, d, f, dtype):
    """D over several 1024-row chunks (2560, 8192), more than 16 rows
    (several row blocks), D not a multiple of 16 (a half-empty last
    tensor-core step), and D or F not multiples of 8 (element loads)."""
    x = _randn((n, d), dtype, dev, 6)
    w = _randn((d,), dtype, dev, 7) + 1.0
    p = _randn((d, f), dtype, dev, 8, scale=d ** -0.5)
    y, normed = kernels.rmsnorm_matmul(x, w, p)
    y_ref, normed_ref = rmsnorm_matmul_ref(x, w, p)
    _close(normed, normed_ref, dtype)
    _close(y, y_ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matmul_unaligned_views(dev, dtype):
    """x, w and W as views one element into their buffers: not 16-byte
    aligned, so the statistics and W take element loads."""
    n, d, f = 4, 960, 960
    xb = _randn((n * d + 1,), dtype, dev, 9)
    wb = _randn((d + 1,), dtype, dev, 10) + 1.0
    pb = _randn((d * f + 1,), dtype, dev, 11, scale=0.02)
    x, w, p = xb[1:].view(n, d), wb[1:], pb[1:].view(d, f)
    y, normed = kernels.rmsnorm_matmul(x, w, p)
    y_ref, normed_ref = rmsnorm_matmul_ref(x, w, p)
    _close(normed, normed_ref, dtype)
    _close(y, y_ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matmul_repeats_bit_for_bit(dev, dtype):
    x = _randn((16, 960), dtype, dev, 12)
    w = _randn((960,), dtype, dev, 13) + 1.0
    p = _randn((960, 960), dtype, dev, 14, scale=0.02)
    runs = [kernels.rmsnorm_matmul(x, w, p) for _ in range(3)]
    for y, normed in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(normed, runs[0][1])


@pytest.mark.parametrize("n,d", [(7, 64), (100, 256), (4, 2560),
                                 (12, 2560), (3, 100), (5, 1001),
                                 (2, 8192)])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dev, n, d, with_res, dtype):
    x = _randn((1, n, d), dtype, dev, 0)
    w = _randn((d,), dtype, dev, 1) + 1.0
    r = _randn((1, n, d), dtype, dev, 2) if with_res else None
    n0 = kernels.rmsnorm.launches
    y, s = kernels.rmsnorm(x, w, r)
    assert kernels.rmsnorm.launches == n0 + 1
    y_ref, s_ref = rmsnorm_ref(x, w, r)
    _close(y, y_ref, dtype)
    _close(s, s_ref, dtype)
    if not with_res:
        assert s is x


@pytest.mark.parametrize("name", ["residual_rmsnorm", "rmsnorm"])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_unaligned_rows(dev, name, with_res, dtype):
    """x contiguous but one element past a 16-byte boundary: the kernel's
    element-wise loads and stores."""
    n, d = 4, 960
    x = _offset_view((n, d), dtype, dev, 0)
    assert x.data_ptr() % 16
    w = _randn((d,), dtype, dev, 1) + 1.0
    r = _randn((n, d), dtype, dev, 2) if with_res else None
    fn = getattr(kernels, name)
    n0 = fn.launches
    y, s = fn(x, w, r)
    assert fn.launches == n0 + 1
    y_ref, s_ref = residual_rmsnorm_ref(x, w, r)
    _close(y, y_ref, dtype)
    _close(s, s_ref, dtype)


def _wkv_inputs(b, t, h, hd, dev, seed):
    """r, k, v, logw (B,T,H,hd), u, s0 at the scales of the reference's
    WKV6 test."""
    r = _randn((b, t, h, hd), torch.float32, dev, seed, 0.5)
    k = _randn((b, t, h, hd), torch.float32, dev, seed + 1, 0.5)
    v = _randn((b, t, h, hd), torch.float32, dev, seed + 2)
    logw = -torch.exp(_randn((b, t, h, hd), torch.float32, dev, seed + 3,
                             0.5) - 2.0)
    u = _randn((h, hd), torch.float32, dev, seed + 4, 0.3)
    s0 = _randn((b, h, hd, hd), torch.float32, dev, seed + 5, 0.1)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("shape", [(1, 32, 2, 16), (2, 45, 3, 8),
                                   (1, 16, 1, 32), (4, 1, 40, 64),
                                   (1, 12, 40, 64), (1, 64, 40, 64),
                                   (2, 3, 2, 128)])
def test_wkv6(dev, shape):
    b, t, h, hd = shape
    args = _wkv_inputs(b, t, h, hd, dev, 0)
    n0 = kernels.wkv6.launches
    o, s = kernels.wkv6(*args)
    assert kernels.wkv6.launches == n0 + 1
    o_ref, s_ref = wkv6_ref(*args)
    _close(o, o_ref, torch.float32)
    _close(s, s_ref, torch.float32)
    o_lit, s_lit = wkv6_oracle(*args)
    _close(o, o_lit, torch.float32)
    _close(s, s_lit, torch.float32)


def test_wkv6_strided_inputs_and_state_in_place(dev):
    """r, k, v, logw as transposed views of (B,H,T,hd) buffers (the Pallas
    layout), and the state written over s0."""
    b, t, h, hd = 2, 20, 3, 64
    args = [a.transpose(1, 2).contiguous().transpose(1, 2) if a.dim() == 4
            and i < 4 else a for i, a in
            enumerate(_wkv_inputs(b, t, h, hd, dev, 10))]
    assert args[0].stride(1) == hd and not args[0].is_contiguous()
    o_ref, s_ref = wkv6_ref(*args)
    state = args[5].clone()
    o, s = kernels.wkv6(*args[:5], state, s_out=state)
    assert s is state
    _close(o, o_ref, torch.float32)
    _close(state, s_ref, torch.float32)


def test_wkv6_extreme_decay(dev):
    b, t, h, hd = 1, 32, 1, 8
    r, k, v = (_randn((b, t, h, hd), torch.float32, dev, s)
               for s in (20, 21, 22))
    even = (torch.arange(t, device=dev) % 2 == 0)[None, :, None, None]
    logw = torch.where(even, -50.0, -1e-4).expand(b, t, h, hd).contiguous()
    u = torch.zeros((h, hd), device=dev)
    s0 = torch.zeros((b, h, hd, hd), device=dev)
    o, s = kernels.wkv6(r, k, v, logw, u, s0)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    o_ref, s_ref = wkv6_oracle(r, k, v, logw, u, s0)
    _close(o, o_ref, torch.float32)
    _close(s, s_ref, torch.float32)


def _wkv6_close_to_both(out, args):
    """The kernel's (o, sT) within TOL of the plain chunked version and of
    the literal float64 recurrence."""
    for plain in (wkv6_ref, wkv6_oracle):
        o_ref, s_ref = plain(*args)
        _close(out[0], o_ref, torch.float32)
        _close(out[1], s_ref, torch.float32)


@pytest.mark.parametrize("t", [15, 16, 17, 33, 1024])
def test_wkv6_chunk_edges(dev, t):
    """T just below, at and past a chunk of 16, a ragged third chunk, and
    64 chunks at the width of RWKV-6 3B's heads; one launch each."""
    args = _wkv_inputs(1, t, 3, 64, dev, 30 + t)
    n0 = kernels.wkv6.launches
    out = kernels.wkv6(*args)
    assert kernels.wkv6.launches == n0 + 1
    _wkv6_close_to_both(out, args)


@pytest.mark.parametrize("t", [1, 20])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
def test_wkv6_every_head_dim(dev, hd, t):
    """Every compiled head size (hd 8 below the 16 columns a CTA owns, so
    one CTA takes the whole head) at B * H = 1, on the step path (T 1)
    and the chunk path."""
    args = _wkv_inputs(1, t, 1, hd, dev, hd + t)
    _wkv6_close_to_both(kernels.wkv6(*args), args)


@pytest.mark.parametrize("t", [1, 33])
def test_wkv6_state_in_place(dev, t):
    """The state written over s0 (the engine's cache) on the step path and
    on the chunk path, where each column CTA reads its columns before it
    writes them."""
    args = _wkv_inputs(2, t, 5, 64, dev, 70 + t)
    state = args[5].clone()
    o, s = kernels.wkv6(*args[:5], state, s_out=state)
    assert s is state
    _wkv6_close_to_both((o, state), args)


@pytest.mark.parametrize("t", [1, 20])
def test_wkv6_unaligned_inputs(dev, t):
    """r, k, v, logw one element past a 16-byte boundary: the kernels'
    scalar path (no 16-byte loads, no bulk copies)."""
    args = _wkv_inputs(2, t, 3, 32, dev, 80 + t)
    seq = [_offset_view(a.shape, torch.float32, dev, 0) for a in args[:4]]
    for view, a in zip(seq, args[:4]):
        view.copy_(a)
    assert all(a.data_ptr() % 16 for a in seq)
    args = (*seq, *args[4:])
    _wkv6_close_to_both(kernels.wkv6(*args), args)


@pytest.mark.parametrize("even,odd", [(-50.0, -1e-4), (-1e-4, -50.0)])
@pytest.mark.parametrize("hd", [8, 64])
def test_wkv6_extreme_decay_over_three_chunks(dev, even, odd, hd):
    """Decays exp(-50) and exp(-1e-4) in turn over 40 tokens (three chunks,
    the last ragged): finite, and within TOL of the float64 recurrence.
    The plain chunked version is not the yardstick here: its f32 cumsum of
    log-decays reaches -400 within a chunk and drops the -1e-4 steps, which
    puts it up to 1.5 x TOL off the recurrence (the kernel's sum is
    compensated)."""
    b, t, h = 1, 40, 2
    r, k, v = (_randn((b, t, h, hd), torch.float32, dev, s)
               for s in (23, 24, 25))
    is_even = (torch.arange(t, device=dev) % 2 == 0)[None, :, None, None]
    logw = torch.where(is_even, even, odd).expand(b, t, h, hd).contiguous()
    u = _randn((h, hd), torch.float32, dev, 26, 0.3)
    s0 = _randn((b, h, hd, hd), torch.float32, dev, 27, 0.1)
    o, s = kernels.wkv6(r, k, v, logw, u, s0)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    o_ref, s_ref = wkv6_oracle(r, k, v, logw, u, s0)
    _close(o, o_ref, torch.float32)
    _close(s, s_ref, torch.float32)


@pytest.mark.parametrize("t", [1, 12, 40])
def test_wkv6_repeats_bit_identical_and_counts_each_launch(dev, t):
    """Three calls in a row give the same bits, and each adds one launch
    (T 12 and 40 end in a ragged chunk)."""
    args = _wkv_inputs(4, t, 40, 64, dev, 90 + t)
    n0 = kernels.wkv6.launches
    outs = [kernels.wkv6(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert kernels.wkv6.launches == n0 + 3
    for o, s in outs[1:]:
        assert torch.equal(o, outs[0][0]) and torch.equal(s, outs[0][1])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _randn((4, 64), torch.float16, dev, 0)
    with pytest.raises(TypeError):
        kernels.residual_rmsnorm(x, torch.ones(64, dtype=x.dtype, device=dev))
    wide = torch.ones((1, 20481), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):   # a row wider than the kernel holds
        kernels.rmsnorm(wide, wide[0])
    q = _randn((1, 4, 256), torch.float32, dev, 0)
    k = _randn((1, 2, 8, 256), torch.float32, dev, 1)
    with pytest.raises(ValueError):
        kernels.decode_attention(q, k, k, scale=1.0)
    with pytest.raises(ValueError):   # mixed devices
        kernels.rmsnorm_matmul(x.float(), torch.ones(64, device=dev),
                               torch.ones(64, 8))
    rows = torch.ones((16 * 65535 + 1, 1), device=dev)
    with pytest.raises(ValueError):   # more row blocks than grid.y holds
        kernels.rmsnorm_matmul(rows, rows[0], torch.ones((1, 8), device=dev))
    q1 = torch.ones((65536, 1, 8), device=dev)
    k1 = torch.ones((65536, 1, 4, 8), device=dev)
    with pytest.raises(ValueError):   # more rows than grid.y holds
        kernels.decode_attention(q1, k1, k1, scale=1.0)
    with pytest.raises(ValueError):   # more than 8 query heads a KV head
        kernels.decode_attention(torch.ones((1, 9, 8), device=dev),
                                 k1[:1], k1[:1], scale=1.0)
    args = list(_wkv_inputs(1, 4, 2, 16, dev, 0))
    with pytest.raises(ValueError):   # bf16
        kernels.wkv6(*[a.bfloat16() for a in args])
    with pytest.raises(ValueError):   # head size the kernel has no case for
        kernels.wkv6(*_wkv_inputs(1, 4, 2, 24, dev, 0))
    with pytest.raises(ValueError):   # r, k, v, logw with other strides
        kernels.wkv6(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                     *args[1:])


def test_paged_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = _randn((2, 4, 32), torch.float32, dev, 0)
    kp = _randn((8, 4, 2, 32), torch.float32, dev, 1)
    bt = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    kt = torch.zeros((8, 4, 32, 2), device=dev).transpose(2, 3)
    call = kernels.paged_decode_attention
    for bad in [
            dict(k_pages=kp[..., :16], v_pages=kp[..., :16]),   # hd differs
            dict(k_pages=kp.bfloat16(), v_pages=kp.bfloat16()),  # dtype
            dict(block_tables=bt.long()), dict(block_tables=bt[:1]),
            dict(kv_lens=lens.float()), dict(kv_lens=lens[:1]),
            dict(k_pages=kt, v_pages=kt)]:                    # hd stride
        args = dict(k_pages=kp, v_pages=kp, block_tables=bt, kv_lens=lens)
        args.update(bad)
        with pytest.raises(ValueError):
            call(q, args["k_pages"], args["v_pages"], args["block_tables"],
                 args["kv_lens"], scale=1.0)
    ks = torch.ones((8, 4, 2), device=dev)
    with pytest.raises(ValueError):   # float pages with scales
        call(q, kp, kp, bt, lens, scale=1.0, k_scale=ks, v_scale=ks)
    k8 = kp.to(torch.int8)
    with pytest.raises(ValueError):   # scales of the wrong shape
        call(q, k8, k8, bt, lens, scale=1.0, k_scale=ks[:, :2],
             v_scale=ks[:, :2])
    with pytest.raises(ValueError):   # one scale missing
        kernels.paged_decode_attention_quant(q, k8, k8, ks, None, bt, lens,
                                             scale=1.0)
    with pytest.raises(ValueError):   # a pool on the CPU
        call(q, kp.cpu(), kp.cpu(), bt, lens, scale=1.0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_offload_round_trip_through_pinned_memory(dev, kv_dtype):
    """An eviction is one copy into one pinned buffer and a restore one
    copy back; the restored pages equal the evicted ones bit for bit and
    the tier times both copies."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kvcache import HostOffloadTier, PagedKVCache
    cfg = reduced(get_config("smollm-360m"))
    kv = PagedKVCache(cfg, num_blocks=8, block_size=4, max_len=16,
                      kv_dtype=kv_dtype, device=dev)
    pages = kv.make_pages()
    for i, leaf in enumerate(t for layer in pages for t in layer.values()):
        src = _randn(leaf.shape, torch.float32, dev, i, scale=40.0)
        leaf.copy_(src.to(leaf.dtype))
    before = [t.clone() for layer in pages for t in layer.values()]
    tier = HostOffloadTier("Intel+H100")
    host = kv.gather_host(pages, [5, 1, 6], timer=tier.copy_timer(dev))
    assert host.buf.is_pinned() and host.buf.dtype == torch.uint8
    tier.evict("r", host, 3)
    kv.zero_pages(pages, [0, 1, 2, 5, 6])
    got, n_blocks, nbytes, _ = tier.restore("r")
    kv.scatter_host(pages, [2, 0, 7], got, timer=tier.copy_timer(dev))
    torch.cuda.synchronize()
    assert n_blocks == 3 and nbytes == kv.block_bytes(pages, 3)
    after = [t for layer in pages for t in layer.values()]
    for old, new in zip(before, after):
        assert torch.equal(new[[2, 0, 7]], old[[5, 1, 6]])
    assert tier.timed_copies == 2 and tier.measured_copy_s > 0
