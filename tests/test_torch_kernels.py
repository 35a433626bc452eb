"""Plain versions of the port's kernels against the reference's Pallas ops.

Each ``repro_torch.kernels`` wrapper given CPU tensors runs its plain
PyTorch version; it is held against the JAX op in interpret mode and the
JAX ``ref.py`` on the same numpy inputs, over a subset of the grids of
``tests/test_kernels.py`` and ``tests/test_fused_kernels.py``.  Tolerance:
2e-5 (f32) and 2e-2 (bf16), absolute and relative, as in those tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jx_decode
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as jx_paged
from repro.kernels.decode_attention.ref import decode_attention_ref as jx_dref
from repro.kernels.flash_attention.ops import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref as jx_fref
from repro.kernels.fused import residual_rmsnorm as jx_res
from repro.kernels.fused import rmsnorm_matmul as jx_rmm
from repro.kernels.fused.residual_rmsnorm.ref import residual_rmsnorm_ref
from repro.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref
from repro.layers.common import rmsnorm as jx_rmsnorm
from repro_torch import kernels
from repro_torch.kernels.decode_attention.ops import split_plan, visit_plan
from repro_torch.kernels.fused.rmsnorm_matmul.ops import (GROUP_ROWS,
                                                          plan_cover)

torch.set_num_threads(2)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(shape, dt, seed, scale=1.0, shift=0.0):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         + shift).astype(np.float32)
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 4, 2, 64, 64, 32),
                                   (1, 6, 2, 37, 37, 16),
                                   (1, 4, 1, 33, 65, 112)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_plain(shape, dt):
    b, hq, hkv, s, t, hd = shape
    jq, q = _pair((b, hq, s, hd), dt, 0)
    jk, k = _pair((b, hkv, t, hd), dt, 1)
    jv, v = _pair((b, hkv, t, hd), dt, 2)
    out = kernels.flash_attention(q, k, v, scale=0.2)
    tol = DTYPES[dt][2]
    _close(out, jx_flash(jq, jk, jv, scale=0.2, block_q=32, block_kv=32),
           tol)
    _close(out, jx_fref(jq, jk, jv, scale=0.2), tol)


@pytest.mark.parametrize("window,cap,kv_len", [(16, 0.0, None),
                                               (0, 8.0, None),
                                               (16, 8.0, 40)])
def test_flash_attention_plain_masks(window, cap, kv_len):
    jq, q = _pair((1, 4, 64, 32), "f32", 3)
    jk, k = _pair((1, 2, 64, 32), "f32", 4)
    jv, v = _pair((1, 2, 64, 32), "f32", 5)
    kw = dict(scale=0.2, causal=True, window=window, softcap=cap)
    out = kernels.flash_attention(q, k, v, kv_len, **kw)
    _close(out, jx_flash(jq, jk, jv, kv_len, block_q=16, block_kv=16, **kw),
           2e-5)
    _close(out, jx_fref(jq, jk, jv, kv_len=kv_len, **kw), 2e-5)


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_flash_attention_plain_t128(dt, tol):
    """SmolLM-360M's heads at the smoke run's 128-token prefill (S = T =
    128, 15 query heads on 5 KV heads, hd 64), against the Pallas kernel in
    interpret mode over several KV tiles."""
    jq, q = _pair((1, 15, 128, 64), dt, 6)
    jk, k = _pair((1, 5, 128, 64), dt, 7)
    jv, v = _pair((1, 5, 128, 64), dt, 8)
    out = kernels.flash_attention(q, k, v, scale=0.125)
    _close(out, jx_flash(jq, jk, jv, scale=0.125, block_q=32, block_kv=32),
           tol)
    _close(out, jx_fref(jq, jk, jv, scale=0.125), tol)


@pytest.mark.parametrize("shape", [(2, 4, 2, 128, 32), (3, 6, 3, 96, 16)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_plain(shape, dt):
    b, hq, hkv, t, hd = shape
    jq, q = _pair((b, hq, hd), dt, 0)
    jk, k = _pair((b, hkv, t, hd), dt, 1)
    jv, v = _pair((b, hkv, t, hd), dt, 2)
    tol = DTYPES[dt][2]
    for kv_len in (t, t // 2, 5):
        out = kernels.decode_attention(q, k, v, kv_len, scale=0.2)
        _close(out, jx_decode(jq, jk, jv, kv_len, scale=0.2, block_kv=64),
               tol)
        _close(out, jx_dref(jq, jk, jv, kv_len, scale=0.2), tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_plain_per_row_lengths(dt):
    """Per-row kv_lens over the engine's (B,T,HKV,hd) cache layout, read
    as a transposed view, against a per-row loop of the JAX op."""
    b, hq, hkv, t, hd = 3, 6, 3, 40, 16
    jq, q = _pair((b, hq, hd), dt, 0)
    jk, k = _pair((b, hkv, t, hd), dt, 1)
    jv, v = _pair((b, hkv, t, hd), dt, 2)
    lens = [1, 17, 40]
    k_cache = k.transpose(1, 2).contiguous()          # (B,T,HKV,hd)
    v_cache = v.transpose(1, 2).contiguous()
    out = kernels.decode_attention(q, k_cache.transpose(1, 2),
                                   v_cache.transpose(1, 2),
                                   torch.tensor(lens, dtype=torch.int32),
                                   scale=0.25)
    for row, n in enumerate(lens):
        sl = slice(row, row + 1)
        ref = jx_decode(jq[sl], jk[sl], jv[sl], n, scale=0.25, block_kv=64)
        _close(out[sl], ref, DTYPES[dt][2])


@pytest.mark.parametrize("shape", [(1, 1, 64), (2, 3, 32), (5, 128)])
def test_residual_rmsnorm_plain(shape):
    d = shape[-1]
    jx, x = _pair(shape, "f32", 0)
    jr, r = _pair(shape, "f32", 1)
    jw, w = _pair((d,), "f32", 2)
    y, s = kernels.residual_rmsnorm(x, w, r)
    jy, js = jx_res(jx, jw, jr)
    _close(y, jy, 2e-5)
    _close(s, js, 2e-5)
    ry, rs = residual_rmsnorm_ref(jx.reshape(-1, d), jw, jr.reshape(-1, d))
    _close(y.reshape(-1, d), ry, 2e-5)
    _close(s.reshape(-1, d), rs, 2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_residual_rmsnorm_plain_without_residual(dt):
    """Without a residual: the JAX op, layers.common.rmsnorm, and the input
    itself returned as the sum."""
    jx, x = _pair((4, 1, 48), dt, 0)
    jw, w = _pair((48,), dt, 1, shift=1.0)
    y, s = kernels.residual_rmsnorm(x, w)
    tol = DTYPES[dt][2]
    _close(y, jx_res(jx, jw)[0], tol)
    _close(y, jx_rmsnorm(jx, jw), tol)
    assert s is x


@pytest.mark.parametrize("name", ["residual_rmsnorm", "rmsnorm"])
@pytest.mark.parametrize("d", [100, 2560])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_norms_plain_at_kernel_widths(name, d, with_res, dt):
    """Both norm wrappers at a width with a scalar tail (100) and RWKV-6's
    2560, against the fused Pallas op and ``layers.common.rmsnorm`` (of the
    f32 sum; in bf16 only without a residual, where the sum is not
    rounded)."""
    jx, x = _pair((5, d), dt, 3)
    jw, w = _pair((d,), dt, 4, shift=1.0)
    jr, r = _pair((5, d), dt, 5) if with_res else (None, None)
    y, s = getattr(kernels, name)(x, w, r)
    tol = DTYPES[dt][2]
    jy, js = jx_res(jx, jw, jr)
    _close(y, jy, tol)
    _close(s, js, tol)
    if not with_res:
        assert s is x
        _close(y, jx_rmsnorm(jx, jw), tol)
    elif dt == "f32":
        _close(y, jx_rmsnorm(jx + jr, jw), tol)


@pytest.mark.parametrize("n,d,f", [(1, 64, 128), (7, 32, 48), (16, 64, 64)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_matmul_plain(n, d, f, dt):
    jx, x = _pair((n, d), dt, 0)
    jw, w = _pair((d,), dt, 1)
    jp, p = _pair((d, f), dt, 2, scale=d ** -0.5)
    y, normed = kernels.rmsnorm_matmul(x, w, p)
    jy, jn = jx_rmm(jx, jw, jp)
    tol = DTYPES[dt][2]
    _close(y, jy, tol)
    _close(normed, jn, tol)
    ry, rn = rmsnorm_matmul_ref(jx, jw, jp)
    _close(y, ry, tol)
    _close(normed, rn, tol)


@pytest.mark.parametrize("n", [4, 16, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_matmul_plain_at_smollm_width(n, dt):
    """SmolLM-360M's fused pair (D = F = 960): decode (4 rows), a slot's
    prefill (16) and a paged prefill chunk (8), against the Pallas kernel
    in interpret mode and the reference's own norm plus a matmul."""
    d = f = 960
    jx, x = _pair((n, d), dt, 20)
    jw, w = _pair((d,), dt, 21, shift=1.0)
    jp, p = _pair((d, f), dt, 22, scale=0.02)
    y, normed = kernels.rmsnorm_matmul(x, w, p)
    tol = DTYPES[dt][2]
    jy, jn = jx_rmm(jx, jw, jp)
    _close(y, jy, tol)
    _close(normed, jn, tol)
    jn2 = jx_rmsnorm(jx, jw)
    _close(normed, jn2, tol)
    _close(y, jnp.matmul(jn2.astype(jnp.float32), jp.astype(jnp.float32)),
           tol)


LENS_T1024 = [1024, 768, 512, 0]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_plain_t1024(dt):
    """SmolLM's heads over a 1024-position cache with lengths
    1024/768/512/0, against the Pallas kernel (one scalar kv_len, so row
    by row, KV tiles of 512) and the JAX ref."""
    b, hq, hkv, t, hd = 4, 15, 5, 1024, 64
    jq, q = _pair((b, hq, hd), dt, 23)
    jk, k = _pair((b, hkv, t, hd), dt, 24)
    jv, v = _pair((b, hkv, t, hd), dt, 25)
    out = kernels.decode_attention(
        q, k, v, torch.tensor(LENS_T1024, dtype=torch.int32), scale=0.125)
    tol = DTYPES[dt][2]
    for row, n in enumerate(LENS_T1024):
        sl = slice(row, row + 1)
        _close(out[sl], jx_decode(jq[sl], jk[sl], jv[sl], n, scale=0.125,
                                  block_kv=512), tol)
        _close(out[sl], jx_dref(jq[sl], jk[sl], jv[sl], n, scale=0.125),
               tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_decode_attention_plain_t1024(dt):
    """The paged pool at T = 1024 (block 64, 16 blocks a row, permuted
    pages, sentinels past each row), lengths 1024/768/512/0, against the
    paged Pallas kernel in interpret mode, which takes the per-row
    lengths."""
    b, hq, hkv, hd, bs = 4, 15, 5, 64, 64
    nb = 1024 // bs
    n_pages = b * nb
    jq, q = _pair((b, hq, hd), dt, 26)
    jkp, kp = _pair((n_pages, bs, hkv, hd), dt, 27)
    jvp, vp = _pair((n_pages, bs, hkv, hd), dt, 28)
    perm = np.random.default_rng(29).permutation(n_pages)
    tables = np.full((b, nb), n_pages, np.int32)
    nxt = 0
    for row, n in enumerate(LENS_T1024):
        for i in range(-(-n // bs)):
            tables[row, i] = perm[nxt]
            nxt += 1
    lens = np.array(LENS_T1024, np.int32)
    out = kernels.paged_decode_attention(q, kp, vp, torch.from_numpy(tables),
                                         torch.from_numpy(lens), scale=0.125)
    _close(out, jx_paged(jq, jkp, jvp, jnp.asarray(tables), jnp.asarray(lens),
                         scale=0.125), DTYPES[dt][2])


@pytest.mark.parametrize("n,d,f", [(4, 960, 960), (16, 960, 960),
                                   (8, 960, 960), (1, 64, 128), (3, 100, 13),
                                   (17, 2560, 24), (40, 1025, 9),
                                   (2, 8192, 16)])
@pytest.mark.parametrize("mma", [False, True])
def test_rmsnorm_matmul_tile_plan_covers_the_product_once(n, d, f, mma):
    """Every (row, column) of the product belongs to one CTA of the plan
    and one of its row groups, and each CTA's chunks and threads (FMA
    kernel) or warps and 16-row steps (tensor-core kernel) take every k
    below D exactly once."""
    owner = np.zeros((n, f), np.int32)
    for (groups, cols), ks in plan_cover(n, d, f, mma):
        for g in groups:
            assert len(g) <= (16 if mma else GROUP_ROWS)
            owner[g.start:g.stop, cols.start:cols.stop] += 1
        seen = np.zeros(d, np.int32)
        for k in ks:
            seen[k.start:k.stop:k.step] += 1
        assert (seen == 1).all()
    assert (owner == 1).all()


@pytest.mark.parametrize("t_len", [1, 7, 100, 128, 129, 1000, 1024, 1025])
@pytest.mark.parametrize("hd", [20, 64, 128])
def test_decode_split_plan_visits_each_position_once(t_len, hd):
    """For every split count (T a multiple of it or not) and lengths 0
    (masked: all T positions), 1, part and past T, the (split, warp, lane
    group) walk of the kernel visits each position below the row's length
    exactly once, and a split that starts past it visits none."""
    for n_split in range(1, 9):
        per = -(-t_len // n_split)
        for length in (0, 1, t_len // 2, t_len, t_len + 5):
            n = t_len if length <= 0 else min(length, t_len)
            visits = visit_plan(n_split, per, t_len, length, hd)
            flat = sorted(t for ts in visits.values() for t in ts)
            assert flat == list(range(n))
            for (s, _, _), ts in visits.items():
                if s * per >= n:
                    assert ts == []
    for rows, heads in ((4, 5), (1, 5), (1, 1), (64, 8)):
        n_split, per = split_plan(t_len, rows, heads)
        assert n_split * per >= t_len > (n_split - 1) * per
        assert n_split == 1 or per >= 64
    assert split_plan(128, 4, 5)[0] == 1          # the main path: one split
    assert split_plan(1024, 4, 5)[0] * 20 >= 132  # T 1024 fills the card


def test_masked_rows_stay_finite():
    """The finite NEG_INF mask: a row with no valid position softmaxes
    uniformly (the mean of V), as the reference does, never NaN."""
    jq, q = _pair((2, 2, 16), "f32", 0)
    jk, k = _pair((2, 1, 8, 16), "f32", 1)
    jv, v = _pair((2, 1, 8, 16), "f32", 2)
    out = kernels.decode_attention(q, k, v, 0, scale=0.25)
    _close(out, jx_dref(jq, jk, jv, 0, scale=0.25), 2e-5)
    mean_v = v.mean(dim=2, keepdim=True).expand(2, 1, 2, 16)
    torch.testing.assert_close(out, mean_v.reshape(2, 2, 16))


def test_cpu_calls_launch_nothing():
    before = kernels.launch_counts()
    x = torch.randn(2, 8)
    kernels.residual_rmsnorm(x, torch.ones(8))
    kernels.rmsnorm_matmul(x, torch.ones(8), torch.randn(8, 4))
    kernels.rmsnorm(x, torch.ones(8), x)
    kernels.wkv6(*(torch.randn(1, 3, 2, 8) for _ in range(4)),
                 torch.randn(2, 8), torch.zeros(1, 2, 8, 8))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("name", sorted(kernels.WRAPPERS))
def test_wrappers_never_fall_back_off_the_cpu(name):
    """A tensor that is neither on the CPU nor on a CUDA device (``meta``
    here, where no GPU exists) is refused, not run by the plain version."""
    meta = dict(device="meta")
    args = {
        "decode_attention": (torch.empty(1, 2, 16, **meta),
                             torch.empty(1, 1, 8, 16, **meta),
                             torch.empty(1, 1, 8, 16, **meta)),
        "flash_attention": (torch.empty(1, 2, 4, 16, **meta),
                            torch.empty(1, 1, 4, 16, **meta),
                            torch.empty(1, 1, 4, 16, **meta)),
        "paged_decode_attention": (
            torch.empty(1, 2, 16, **meta), torch.empty(4, 8, 1, 16, **meta),
            torch.empty(4, 8, 1, 16, **meta),
            torch.zeros(1, 2, dtype=torch.int32, **meta),
            torch.zeros(1, dtype=torch.int32, **meta)),
        "paged_decode_attention_quant": (
            torch.empty(1, 2, 16, **meta),
            torch.zeros(4, 8, 1, 16, dtype=torch.int8, **meta),
            torch.zeros(4, 8, 1, 16, dtype=torch.int8, **meta),
            torch.empty(4, 8, 1, **meta), torch.empty(4, 8, 1, **meta),
            torch.zeros(1, 2, dtype=torch.int32, **meta),
            torch.zeros(1, dtype=torch.int32, **meta)),
        "residual_rmsnorm": (torch.empty(2, 8, **meta),
                             torch.empty(8, **meta)),
        "rmsnorm_matmul": (torch.empty(2, 8, **meta), torch.empty(8, **meta),
                           torch.empty(8, 4, **meta)),
        "rmsnorm": (torch.empty(2, 8, **meta), torch.empty(8, **meta),
                    torch.empty(2, 8, **meta)),
        "wkv6": (*(torch.empty(1, 3, 2, 16, **meta) for _ in range(4)),
                 torch.empty(2, 16, **meta),
                 torch.empty(1, 2, 16, 16, **meta)),
    }[name]
    kw = {"scale": 1.0} if "attention" in name else {}
    with pytest.raises(ValueError, match="CUDA"):
        kernels.WRAPPERS[name](*args, **kw)
