"""The cross-attention stacks' kernel shapes and decode bodies, on the card.

Marked ``cuda``: each test skips without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda_xattn.py

* ``flash_attention`` non-causal with S != T: a served cross prefill (a
  16-token bucket over one source row, S > T, so the wrapper's query
  offset T - S is negative), a prefill over image patches (T 1601, not a
  multiple of the 64-key tile) and over encoder frames, and the encoder
  itself (S = T);
* ``decode_attention`` over a whole cross cache (every row at all T
  positions: T 1, 1601 and 4096, GQA groups 4 and 1);
* ``rmsnorm_matmul`` at the two untied heads' widths (4096 x 128256,
  1024 x 256206), at a reduced vocabulary for f32;
* each reduced config's decode body (a one-row served cross cache, and a
  cross cache written by a prefill with the cross inputs) captured as a
  CUDA graph and replayed, against the same body run directly, bit for
  bit.

Tolerance as in ``test_torch_cuda_kernels.py``: the largest absolute error
at most 2e-5 (f32) or 2e-2 (bf16) times max(1, max |plain|).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref
from repro_torch.models import forward, init_params, make_cache

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
NAMES = ("llama-3.2-vision-11b", "seamless-m4t-medium")


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


# (B, HQ, HKV, hd, S, T): the served cross prefill (S > T = 1) at both
# configs' heads, a prefill over Llama-3.2-Vision's 1601 patches, one over
# frames at Seamless's heads, and the encoder (S = T)
FLASH = [(1, 32, 8, 128, 16, 1), (1, 16, 16, 64, 16, 1),
         (4, 32, 8, 128, 16, 1601), (2, 16, 16, 64, 12, 1000),
         (1, 16, 16, 64, 1024, 1024), (2, 32, 8, 128, 3, 65)]


@pytest.mark.parametrize("shape", FLASH)
@pytest.mark.parametrize("dtype", DTYPES)
def test_noncausal_flash_with_s_unlike_t(dev, shape, dtype):
    b, hq, hkv, hd, s, t = shape
    q = _randn((b, s, hq, hd), dtype, dev, 1).transpose(1, 2)
    k = _randn((b, t, hkv, hd), dtype, dev, 2).transpose(1, 2)
    v = _randn((b, t, hkv, hd), dtype, dev, 3).transpose(1, 2)
    out = kernels.flash_attention(q, k, v, scale=hd ** -0.5, causal=False)
    ref = attention_ref(q, k, v, scale=hd ** -0.5, causal=False)
    _close(out, ref, dtype)
    if t == 1:
        # one source row: every query's output is that row's V
        _close(out, v.expand(b, hkv, s, hd).repeat_interleave(hq // hkv, 1)
               .contiguous(), dtype)


# (B, HQ, HKV, hd, T): every row over the whole cross cache
DECODE = [(4, 32, 8, 128, 1), (4, 16, 16, 64, 1), (4, 32, 8, 128, 1601),
          (4, 16, 16, 64, 4096), (1, 32, 8, 128, 1601)]


@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_over_the_whole_cross_cache(dev, shape, dtype):
    b, hq, hkv, hd, t = shape
    q = _randn((b, hq, hd), dtype, dev, 4)
    k = _randn((b, t, hkv, hd), dtype, dev, 5).transpose(1, 2)
    v = _randn((b, t, hkv, hd), dtype, dev, 6).transpose(1, 2)
    out = kernels.decode_attention(q, k, v, scale=hd ** -0.5)
    ref = decode_attention_ref(q, k, v, scale=hd ** -0.5)
    _close(out, ref, dtype)
    full = torch.full((b,), t, dtype=torch.int32, device=dev)
    _close(kernels.decode_attention(q, k, v, full, scale=hd ** -0.5), out,
           dtype)


# the untied heads: (D, V); f32 at a cut vocabulary (the whole f32 heads
# are 2.1 and 1.0 GB)
HEADS = [(4096, 128256), (1024, 256206)]


@pytest.mark.parametrize("rows", [1, 4, 16])
@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matmul_at_the_untied_heads(dev, head, rows, dtype):
    d, f = head
    if dtype == torch.float32:
        f = 8200
    x = _randn((rows, 1, d), dtype, dev, 7)
    w = _randn((d,), dtype, dev, 8) + 1.0
    gen = torch.Generator(device=dev).manual_seed(9)
    wp = (torch.randn((d, f), generator=gen, device=dev) * 0.02).to(dtype)
    out = kernels.rmsnorm_matmul(x, w, wp)
    ref = rmsnorm_matmul_ref(x, w, wp)
    for o, r in zip(out, ref):
        _close(o, r, dtype)


@pytest.mark.parametrize("inputs", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_decode_body_replays_its_direct_output(dev, name, inputs):
    """Each config's decode body, captured as one CUDA graph with the
    cross caches among its inputs, replays the bits of the same body run
    directly: over the served one-row cross cache, and over a cross cache
    a prefill with the cross inputs wrote (gate 0.5, so the vision cross
    layers count)."""
    cfg = reduced(get_config(name))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    for blk in params["blocks"]:
        if "xgate" in blk:
            blk["xgate"].fill_(0.5)
    b, t = 4, 32
    src = cfg.n_frontend_tokens if inputs else 1
    cache = make_cache(cfg, b, t, src_len=src, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, 8))).to(dev)
    kw = {}
    if inputs:
        key = "encoder_tokens" if cfg.n_encoder_layers else "frontend_embeds"
        kw[key] = _randn((b, src, cfg.d_model), torch.float32, dev, 2)
    forward(params, prompt, cfg, cache=cache, **kw)
    body = make_step_bodies(cfg).decode
    toks = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    lens = torch.full((b,), 8, dtype=torch.int32, device=dev)
    saved = [{k: v.clone() for k, v in c.items()} for c in cache]
    direct, _ = body(params, cache, toks, lens)
    direct = direct.clone()
    for c, s in zip(cache, saved):
        for k, v in c.items():
            v.copy_(s[k])
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        body(params, cache, toks, lens)
    torch.cuda.synchronize(dev)
    for c, s in zip(cache, saved):
        for k, v in c.items():
            v.copy_(s[k])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out, _ = body(params, cache, toks, lens)
    graph.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(out, direct)
