"""The port's paged-KV modules against the reference's, on the CPU.

* the paged plain versions (``paged_decode_attention_ref`` and its int8
  twin, through the wrapper) against the JAX Pallas kernels in interpret
  mode and the JAX refs, on the shape grids of the reference's paged and
  int8 kernel tests, with permuted pages, sentinel and garbage table
  entries (atol = rtol = 2e-5);
* ``quantize_kv`` bit-exact against the reference, zero and denormal rows
  included;
* ``BlockPool``, ``default_num_blocks``, ``offload_cost_s``, the offload
  tier's accounting and ``PagedKVCache.block_bytes`` equal to the
  reference's;
* a paged forward of reduced SmolLM in f32 (chunks of 4, then batched
  decode steps) against ``repro.models.forward(..., block_tables=...)``
  with full-precision and int8 pages (logits within 1e-4), and the kernel
  calls it makes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core import device_model as jx_dm
from repro.inference import kv_quant as jx_kvq
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as jx_paged
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_quant_ref as jx_qref
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as jx_ref
from repro.kvcache import BlockPool as JxBlockPool
from repro.kvcache import HostOffloadTier as JxTier
from repro.kvcache import PagedKVCache as JxPagedKVCache
from repro.kvcache import default_num_blocks as jx_default_num_blocks
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_paged_cache as jx_make_paged_cache
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.core import device_model as dm
from repro_torch.inference import kv_quant
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kvcache import (BlockPool, HostOffloadTier, HostPages,
                                 PagedKVCache, default_num_blocks)
from repro_torch.models import forward, make_paged_cache
from repro_torch.telemetry.registry import MetricsRegistry

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_ATOL = 1e-4


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pool(b, hq, hkv, t, hd, bs, seed=0):
    """Contiguous (B,HKV,T,hd) K/V scattered into permuted pages of a pool
    twice the size needed; unused table entries hold a sentinel past the
    pool.  Returns numpy q, k, v, k_pages, v_pages, tables, lens."""
    n_pages = 2 * (b * t // bs)
    q = _normal(seed, (b, hq, hd))
    k = _normal(seed + 1, (b, hkv, t, hd))
    v = _normal(seed + 2, (b, hkv, t, hd))
    lens = np.array([t - 3 * i for i in range(b)], np.int32)
    perm = np.random.default_rng(seed).permutation(n_pages)
    tables = np.full((b, t // bs), n_pages + 3, np.int32)
    kp = np.zeros((n_pages, bs, hkv, hd), np.float32)
    vp = np.zeros((n_pages, bs, hkv, hd), np.float32)
    nxt = 0
    for row in range(b):
        for i in range(-(-int(lens[row]) // bs)):
            pg = int(perm[nxt])
            nxt += 1
            tables[row, i] = pg
            kp[pg] = k[row, :, i * bs:(i + 1) * bs].transpose(1, 0, 2)
            vp[pg] = v[row, :, i * bs:(i + 1) * bs].transpose(1, 0, 2)
    return q, k, v, kp, vp, tables, lens


T_ = torch.from_numpy
J_ = jnp.asarray
GRID = [((2, 6, 2, 32, 32), 8), ((1, 4, 4, 64, 16), 16),
        ((3, 8, 2, 128, 64), 32)]


# ------------------------------------------------------------ kernels
@pytest.mark.parametrize("shape,bs", GRID)
def test_paged_plain_matches_the_pallas_kernel_and_refs(shape, bs):
    b, hq, hkv, t, hd = shape
    q, k, v, kp, vp, tables, lens = _pool(b, hq, hkv, t, hd, bs)
    out = kernels.paged_decode_attention(T_(q), T_(kp), T_(vp), T_(tables),
                                         T_(lens), scale=0.2).numpy()
    pallas = jx_paged(J_(q), J_(kp), J_(vp), J_(tables), J_(lens), scale=0.2)
    ref = jx_ref(J_(q), J_(kp), J_(vp), J_(tables), J_(lens), scale=0.2)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    for row in range(b):             # the contiguous oracle, row by row
        rc = decode_attention_ref(T_(q[row:row + 1]), T_(k[row:row + 1]),
                                  T_(v[row:row + 1]), int(lens[row]),
                                  scale=0.2)
        np.testing.assert_allclose(out[row:row + 1], rc.numpy(), **TOL)


def test_paged_plain_ignores_sentinel_and_garbage_table_entries():
    b, hq, hkv, t, hd, bs = 1, 2, 1, 32, 16, 8
    q, k, v, kp, vp, tables, _ = _pool(b, hq, hkv, t, hd, bs)
    lens = np.array([9], np.int32)                 # 2 of 4 pages valid
    n_pages = kp.shape[0]
    garbage = tables.copy()
    garbage[0, 2:] = [0, n_pages + 1000]           # valid-range AND huge ids
    outs = [kernels.paged_decode_attention(T_(q), T_(kp), T_(vp), T_(tb),
                                           T_(lens), scale=0.2).numpy()
            for tb in (tables, garbage)]
    np.testing.assert_array_equal(outs[0], outs[1])
    pallas = jx_paged(J_(q), J_(kp), J_(vp), J_(garbage), J_(lens),
                      scale=0.2)
    np.testing.assert_allclose(outs[1], np.asarray(pallas), **TOL)


def test_paged_plain_zero_length_row_is_uniform_like_the_reference():
    q, _, _, kp, vp, tables, _ = _pool(2, 4, 2, 32, 16, 8)
    lens = np.array([0, 20], np.int32)
    out = kernels.paged_decode_attention(T_(q), T_(kp), T_(vp), T_(tables),
                                         T_(lens), scale=0.2).numpy()
    pallas = jx_paged(J_(q), J_(kp), J_(vp), J_(tables), J_(lens), scale=0.2)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("shape,bs", GRID[:2])
def test_quant_paged_plain_matches_the_pallas_kernel_and_ref(shape, bs):
    b, hq, hkv, t, hd = shape
    q, _, _, kp, vp, tables, lens = _pool(b, hq, hkv, t, hd, bs, seed=3)
    qk, sk = jx_kvq.quantize_kv(J_(kp))
    qv, sv = jx_kvq.quantize_kv(J_(vp))
    pallas = jx_paged(J_(q), qk, qv, J_(tables), J_(lens), scale=0.2,
                      k_scale=sk, v_scale=sv)
    ref = jx_qref(J_(q), qk, qv, sk, sv, J_(tables), J_(lens), scale=0.2)
    n = lambda a: T_(np.array(a))                  # noqa: E731
    before = kernels.paged_decode_attention_quant.launches
    out = kernels.paged_decode_attention(
        T_(q), n(qk), n(qv), T_(tables), T_(lens), scale=0.2,
        k_scale=n(sk), v_scale=n(sv)).numpy()
    assert kernels.paged_decode_attention_quant.launches == before  # CPU
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


# ------------------------------------------------------------ kv_quant
def test_quantize_kv_is_bit_exact_with_the_reference():
    x = _normal(4, (6, 5, 16)) * 3.0
    x[0, 0] = 0.0                                    # zero row
    x[1, 1] = np.float32(1e-41) * np.arange(16)      # denormal row
    x[2, 2, :] = 1e-9                                # under the 1e-8 floor
    x[3, 3, 0] = 1e30                                # one huge entry
    x[4, 4] = np.linspace(-127, 127, 16)             # exact half steps
    q, s = kv_quant.quantize_kv(T_(x))
    jq, js = jx_kvq.quantize_kv(J_(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(
        kv_quant.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jx_kvq.dequantize_kv(jq, js, jnp.float32)))
    for hd in (16, 64, 128):
        for kd in kv_quant.KV_DTYPES:
            assert kv_quant.kv_entry_bytes(hd, kd) == \
                jx_kvq.kv_entry_bytes(hd, kd)
        assert kv_quant.capacity_ratio(hd) == jx_kvq.capacity_ratio(hd)


# ------------------------------------------------------------ allocator
def _pool_ops(pool):
    """One op sequence through a pool; returns everything it observed."""
    seen = [pool.alloc("a", 3), pool.alloc("b", 2),
            pool.adopt("c", pool.owned("a")[:2]), pool.cow("c", 1),
            pool.ensure("b", 13), pool.trim("b", 5), pool.free("a"),
            pool.alloc("d", 2), pool.ensure("d", 4)]
    try:
        pool.alloc("e", 99)
    except MemoryError:
        seen.append("exhausted")
    pool.block_bytes = 640
    seen += [pool.adopt("e", pool.owned("c")), pool.bytes_saved,
             pool.shared_blocks, pool.extra_refs, pool.peak_shared_blocks,
             pool.cow_copies_total, pool.free("c"), pool.trim("e", 0)]
    seen += [[pool.ref_count(i) for i in range(pool.num_blocks)],
             {o: pool.owned(o) for o in pool.owners()}, pool.free_blocks,
             pool.utilization]
    seen += [list(pool.table_row(o, 5, sentinel=pool.num_blocks))
             for o in ("b", "d", "e", "ghost")]
    return seen


def test_block_pool_matches_the_reference_op_for_op():
    reg = MetricsRegistry()
    pool = BlockPool(10, 4)
    pool.bind_metrics(reg)
    assert _pool_ops(pool) == _pool_ops(JxBlockPool(10, 4))
    snap = reg.snapshot()
    assert snap["kvcache_blocks_used"]["series"][0]["value"] == \
        pool.used_blocks
    assert snap["kv_cow_copies_total"]["series"][0]["value"] == 1
    with pytest.raises(ValueError):
        BlockPool(0, 4)
    with pytest.raises(ValueError):
        pool.cow("d", 0)                   # not shared


def test_pool_sizing_and_offload_pricing_match_the_reference():
    for args in [(4, 64, 16), (4, 128, 16), (2, 32, 4), (3, 100, 7)]:
        for kw in [{}, dict(num_blocks=5), dict(kv_dtype="int8", hd=64),
                   dict(kv_dtype="int8", hd=16, payload_bytes=4)]:
            assert default_num_blocks(*args, **kw) == \
                jx_default_num_blocks(*args, **kw)
    assert default_num_blocks(4, 128, 16, kv_dtype="int8", hd=64) == 60
    assert set(dm.PLATFORMS) == set(jx_dm.PLATFORMS)
    for name, spec in dm.PLATFORMS.items():
        assert vars(spec) == vars(jx_dm.PLATFORMS[name])
        for nbytes, n in [(0, 2), (1 << 20, 1), (123457, 9)]:
            assert dm.offload_cost_s(spec, nbytes, n) == \
                jx_dm.offload_cost_s(jx_dm.PLATFORMS[name], nbytes, n)
    with pytest.raises(ValueError):
        dm.offload_cost_s(dm.PLATFORMS["GH200"], -1)


@pytest.mark.parametrize("platform", ["Intel+H100", "GH200"])
def test_offload_tier_accounting_matches_the_reference(platform):
    leaves = [_normal(5, (2, 4, 2, 16)), np.zeros((2, 4, 2), np.float32),
              np.zeros((2, 4, 2, 16), np.int8)]
    layout, total = HostPages.plan([T_(a) for a in leaves], 2)
    host = HostPages(torch.zeros(total, dtype=torch.uint8), layout)
    tier, jtier = HostOffloadTier(platform), JxTier(platform)
    assert tier.evict(7, host, 2) == jtier.evict(7, leaves, 2)
    got, jgot = tier.restore(7), jtier.restore(7)
    assert got[0] is host and got[1:] == jgot[1:] and not tier.holds(7)
    assert tier.modeled_tax_s == jtier.modeled_tax_s
    assert tier.measured_copy_s == 0.0     # nothing is timed on the CPU


# ------------------------------------------------------------ model
@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_block_bytes_and_page_ops(setup, kv_dtype):
    jcfg, cfg, _, _ = setup
    kv = PagedKVCache(cfg, num_blocks=6, block_size=4, max_len=16,
                      kv_dtype=kv_dtype, device="cpu")
    jkv = JxPagedKVCache(jcfg, num_blocks=6, block_size=4, max_len=16,
                         kv_dtype=kv_dtype)
    pages, jpages = kv.make_pages(), jkv.make_pages()
    assert kv.pool.block_bytes == jkv.pool.block_bytes
    assert kv.block_bytes(pages, 3) == jkv.block_bytes(jpages, 3)
    for leaf in (t for layer in pages for t in layer.values()):
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    host = kv.gather_host(pages, [1, 4])
    assert host.buf.dtype == torch.uint8 and host.buf.dim() == 1
    assert host.nbytes == \
        sum(a.nbytes for a in jkv.gather_host(jpages, [1, 4]))
    kv.copy_pages(pages, 1, 2)
    kv.zero_pages(pages, [1, 4])
    kv.scatter_host(pages, [4, 5], host)
    leaves = [layer[key] for layer in pages for key in sorted(layer)]
    staged = host.leaves()
    assert len(leaves) == len(staged)
    for t, h in zip(leaves, staged):    # h holds the old pages 1 and 4
        assert h.dtype == t.dtype
        assert not t[1].any()
        assert torch.equal(t[2], h[0]) and torch.equal(t[4], h[0])
        assert torch.equal(t[5], h[1])
    assert list(kv.block_tables(["x", None])[1]) == [6] * 4


def test_make_paged_cache_rejects_non_attention(setup):
    """A recurrent stack the port runs (RWKV-6) raises the reference's
    ValueError; one it does not run yet raises NotImplementedError."""
    _, cfg, _, _ = setup
    with pytest.raises(ValueError, match="pure-attention"):
        make_paged_cache(cfg.replace(block_pattern=("rwkv6",)), 8, 4,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        make_paged_cache(cfg.replace(block_pattern=("mamba",)), 8, 4,
                         device="cpu")


def _spy(monkeypatch):
    calls = {name: 0 for name in kernels.WRAPPERS}
    for name, fn in kernels.WRAPPERS.items():
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_forward_matches_the_reference(setup, kv_dtype, monkeypatch):
    jcfg, cfg, jparams, params = setup
    b, max_len, bs = 2, 32, 8
    pool = b * (max_len // bs)
    sentinel = pool + 5
    prompts = [[5, 9, 2, 7, 1], [3, 8, 4, 4, 6, 2, 9, 1, 5]]
    jcache = jx_make_paged_cache(jcfg, pool, bs, dtype=jcfg.cdtype,
                                 kv_dtype=kv_dtype)
    cache = make_paged_cache(cfg, pool, bs, kv_dtype=kv_dtype, device="cpu")
    tables = np.full((b, max_len // bs), sentinel, np.int32)
    free = list(np.random.default_rng(0).permutation(pool))
    calls = _spy(monkeypatch)
    n = cfg.n_layers
    quant = kv_dtype == "int8"
    paged = "paged_decode_attention" + ("_quant" if quant else "")
    for i, p in enumerate(prompts):     # chunked prefill, chunks of 4
        t0 = 0
        while t0 < len(p):
            chunk = p[t0:t0 + 4]
            while (tables[i] != sentinel).sum() * bs < t0 + len(chunk):
                tables[i, (tables[i] != sentinel).sum()] = free.pop(0)
            jl, _, jcache = jx_forward(
                jparams, J_([chunk]), jcfg, cache=jcache,
                cache_index=jnp.asarray(t0, jnp.int32),
                block_tables=J_(tables[i:i + 1]))
            for name in calls:
                calls[name] = 0
            tl, _ = forward(params, np.asarray([chunk]), cfg, cache=cache,
                            cache_index=t0, block_tables=tables[i:i + 1])
            assert calls["flash_attention"] == n and calls[paged] == 0
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_ATOL)
            t0 += len(chunk)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for step in range(2):               # batched decode steps
        tok = np.random.default_rng(step).integers(
            0, cfg.vocab_size, (b, 1)).astype(np.int32)
        for i in range(b):
            if (tables[i] != sentinel).sum() * bs < lengths[i] + 1:
                tables[i, (tables[i] != sentinel).sum()] = free.pop(0)
        jl, _, jcache = jx_forward(jparams, J_(tok), jcfg, cache=jcache,
                                   lengths=J_(lengths),
                                   block_tables=J_(tables))
        for name in calls:
            calls[name] = 0
        tl, _ = forward(params, tok, cfg, cache=cache, lengths=lengths,
                        block_tables=tables)
        assert calls == {**{k: 0 for k in calls}, "rmsnorm_matmul": n,
                         "residual_rmsnorm": n + 1, paged: n}
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        lengths += 1
    if not quant:                        # the pages themselves agree
        for i in range(n):
            for name in ("k_pages", "v_pages"):
                np.testing.assert_allclose(
                    cache[i][name].numpy(),
                    np.asarray(jcache["slot0"]["self"][name][i]),
                    atol=LOGIT_ATOL)
