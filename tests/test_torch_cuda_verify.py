"""The multi-query decode-attention kernels and speculative serving, on the
card.

Marked ``cuda``: each test skips without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda_verify.py

* ``decode_attention_mq``, ``paged_decode_attention_mq`` and
  ``paged_decode_attention_quant_mq`` against their plain versions at
  S = 2, 5 and 9, with one split (T 128) and several (T 1024), GQA groups
  up to 8, windows and softcaps, lengths short of S and past T, padding
  columns past the cache and sentinel table entries;
* each query of a multi-query call bit for bit equal to the single-token
  kernel called at that query's length (the split plan is the B-row one):
  the verify's attention is the decode step's;
* a speculative engine (reduced SmolLM, f32) serving the plain engine's
  tokens on the contiguous cache and both pools, its verify launching the
  multi-query entries and nothing else of attention.

Tolerance as in ``test_torch_cuda_kernels.py``: the largest absolute error
at most 2e-5 (f32) or 2e-2 (bf16) times max(1, max |plain|).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.kv_quant import quantize_kv
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_mq_ref, paged_decode_attention_mq_ref,
    paged_decode_attention_quant_mq_ref)
from repro_torch.models import init_params

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


def _randn(shape, dtype, dev, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    bound = TOL[dtype] * max(1.0, ref.float().abs().max().item())
    assert err <= bound, (err, bound)


def _inputs(b, s, hq, hkv, t, hd, bs, dtype, dev, lens, seed=0):
    """q, the contiguous cache views, a pool holding the same logical KV in
    permuted pages (bf16/f32 and int8), the tables (sentinels past each
    row's pages) and the lengths."""
    q = _randn((b, s, hq, hd), dtype, dev, seed)
    k = _randn((b, t, hkv, hd), dtype, dev, seed + 1)
    v = _randn((b, t, hkv, hd), dtype, dev, seed + 2)
    nb = t // bs
    n_pages = b * nb + 3
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        n_pages)[:b * nb].reshape(b, nb).astype(np.int32)).to(dev)
    kp = torch.zeros((n_pages, bs, hkv, hd), dtype=dtype, device=dev)
    vp = torch.zeros_like(kp)
    kp[perm.long()] = k.reshape(b, nb, bs, hkv, hd)
    vp[perm.long()] = v.reshape(b, nb, bs, hkv, hd)
    table = perm.clone()
    for row, n in enumerate(lens):       # sentinels past the row's pages
        used = -(-max(min(n, t), 0) // bs)
        table[row, used:] = n_pages + 7
    kq, ks = quantize_kv(kp.float())
    vq, vs = quantize_kv(vp.float())
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k.transpose(1, 2), v.transpose(1, 2), kp, vp, kq, ks, vq, vs, \
        table, lens_t


# (B, HQ, HKV, T, hd): SmolLM's decode shape, GQA 8 at hd 128, T 1024 split
SHAPES = [(4, 15, 5, 128, 64), (3, 32, 4, 128, 128), (4, 15, 5, 1024, 64)]
OPTS = [(0, 0.0), (16, 50.0), (4, 0.0)]


@pytest.mark.parametrize("window,cap", OPTS)
@pytest.mark.parametrize("s", [2, 5, 9])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_multi_query_entries(dev, shape, s, window, cap, dtype):
    b, hq, hkv, t, hd = shape
    # ragged rows: one short of S (its first queries see nothing), one
    # whose window runs past T, one full
    lens = [28, s - 1, t + 3, t][:b] + [17] * max(0, b - 4)
    (q, k, v, kp, vp, kq, ks, vq, vs, table,
     lens_t) = _inputs(b, s, hq, hkv, t, hd, 16, dtype, dev, lens)
    opts = dict(scale=hd ** -0.5, window=window, softcap=cap)
    before = dict(kernels.launch_counts())
    _close(kernels.decode_attention_mq(q, k, v, lens_t, **opts),
           decode_attention_mq_ref(q, k, v, lens_t, **opts), dtype)
    _close(kernels.paged_decode_attention_mq(q, kp, vp, table, lens_t,
                                             **opts),
           paged_decode_attention_mq_ref(q, kp, vp, table, lens_t, **opts),
           dtype)
    _close(kernels.paged_decode_attention_quant_mq(q, kq, vq, ks, vs, table,
                                                   lens_t, **opts),
           paged_decode_attention_quant_mq_ref(q, kq, vq, ks, vs, table,
                                               lens_t, **opts), dtype)
    after = kernels.launch_counts()
    for name in ("decode_attention_mq", "paged_decode_attention_mq",
                 "paged_decode_attention_quant_mq"):
        assert after[name] == before[name] + 1


@pytest.mark.parametrize("t", [128, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_each_query_is_a_decode_step_bit_for_bit(dev, t, dtype):
    """Query j of a multi-query call equals the single-token kernel at
    length kv_lens - (S-1-j), bit for bit: same split plan, same order."""
    b, s, hq, hkv, hd = 4, 5, 15, 5, 64
    lens = [28, 21, 17, 13] if t == 128 else [1024, 768, 512, 256]
    (q, k, v, kp, vp, kq, ks, vq, vs, table,
     lens_t) = _inputs(b, s, hq, hkv, t, hd, 16, dtype, dev, lens)
    opts = dict(scale=hd ** -0.5)
    mq = kernels.decode_attention_mq(q, k, v, lens_t, **opts)
    pmq = kernels.paged_decode_attention_mq(q, kp, vp, table, lens_t, **opts)
    qmq = kernels.paged_decode_attention_quant_mq(q, kq, vq, ks, vs, table,
                                                  lens_t, **opts)
    for j in range(s):
        lj = lens_t - (s - 1 - j)
        qj = q[:, j].contiguous()
        assert torch.equal(mq[:, j],
                           kernels.decode_attention(qj, k, v, lj, **opts))
        assert torch.equal(pmq[:, j], kernels.paged_decode_attention(
            qj, kp, vp, table, lj, **opts))
        assert torch.equal(qmq[:, j], kernels.paged_decode_attention_quant(
            qj, kq, vq, ks, vs, table, lj, **opts))


def test_multi_query_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 3, 4, 16, device=dev)
    k = torch.zeros(2, 2, 8, 16, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="B,S,HQ,hd"):
        kernels.decode_attention_mq(q[:, 0], k, k, lens, scale=1.0)
    with pytest.raises(ValueError, match="kv_lens"):
        kernels.decode_attention_mq(q, k, k, lens.long(), scale=1.0)
    with pytest.raises(ValueError, match="exceed the kernel's grid"):
        n = 65536
        kernels.decode_attention_mq(
            torch.zeros(n, 2, 4, 16, device=dev),
            torch.zeros(n, 2, 8, 16, device=dev),
            torch.zeros(n, 2, 8, 16, device=dev),
            torch.ones(n, dtype=torch.int32, device=dev), scale=1.0)


@pytest.mark.parametrize("cache_kw", [
    {}, dict(cache="paged", block_size=4),
    dict(cache="paged", block_size=4, kv_dtype="int8")],
    ids=["contiguous", "paged", "int8"])
def test_speculative_engine_serves_the_plain_tokens(dev, cache_kw):
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    def run(eng=None, **kw):
        rng = np.random.default_rng(7)
        reqs = [Request(i, prompt=[int(x) for x in rng.integers(
            1, cfg.vocab_size, 5 + i)], max_new_tokens=10) for i in range(3)]
        if eng is None:
            eng = ServeEngine(cfg, params, max_batch=4, max_len=64,
                              device=dev, **cache_kw, **kw)
        kernels.reset_launch_counts()
        return {r.rid: r.generated for r in eng.run(reqs)}, eng, \
            kernels.launch_counts()

    plain, _, _ = run()
    toks, eng, counts = run(speculative=True, spec_k=4)
    assert toks == plain
    # again on the captured graphs: the first run's counts hold each
    # capture's warm-up call too
    eng.reset()
    toks, _, counts = run(eng=eng)
    assert toks == plain
    rounds, n, nd = eng.stats.spec_rounds, cfg.n_layers, eng.draft_cfg.n_layers
    assert rounds > 0
    # each round: the target's verify (contiguous: decode_attention_mq;
    # paged: the pool's _mq entry), the draft's width-2 catch-up step
    # (decode_attention_mq on its contiguous cache) and its k - 1 single
    # steps (decode_attention)
    verify = ("decode_attention_mq" if not cache_kw else
              "paged_decode_attention" + ("_quant" if "kv_dtype" in cache_kw
                                          else "") + "_mq")
    want = {"decode_attention_mq": nd * rounds,
            "decode_attention": nd * 3 * rounds}
    want[verify] = want.get(verify, 0) + n * rounds
    assert {k: counts[k] for k in want} == want
