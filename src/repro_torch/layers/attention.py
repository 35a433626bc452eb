"""GQA self-attention over a contiguous or a paged KV cache.

Counterpart of the self-attention paths of ``attention_fwd`` in
``repro/layers/attention.py`` (cross-attention and sharding come with
later slices; see ROADMAP).  Where the reference computes attention in
plain XLA, the port routes it through its hand-written kernels.  As there:
q, k and v take their biases after their projections when the config has
``qkv_bias`` (q's after the fused RMSNorm+matmul kernel produced it); the
scores are soft-capped by ``cfg.attn_softcap``; a layer's ``window`` (its
``sliding_window`` on an ``attn_local`` layer, else 0) limits every query
to the last ``window`` positions; and an encoder-only family
(``cfg.family == "encoder"``) attends without the causal mask.

Contiguous cache, (B,T,HKV,hd) per layer:

  * decode (one new token per row, per-row ``lengths``): the token's K/V
    are written at ``lengths[b]`` and ``kernels.decode_attention`` reads the
    cache in place through a transposed view, with per-row
    ``kv_lens = lengths + 1``;
  * prefill at ``cache_index`` (and a forward without cache): K/V are
    written to ``[cache_index, cache_index + S)`` and
    ``kernels.flash_attention`` attends over the first ``cache_index + S``
    positions, queries right-aligned, so a prefill from 0 attends over the
    prompt's own K/V (T = S, ``q_offset`` 0).

Paged cache, a pool of (P,bs,HKV,hd) pages per layer
(``make_paged_self_cache``; int8 payloads plus (P,bs,HKV) f32 scales when
quantized), reached through a (B,NB) block table (``_paged_attention_fwd``
in the reference):

  * writes: each new token's page ``bt[b, t // bs]`` and offset ``t % bs``;
    an int8 pool quantizes on write;
  * decode: ``kernels.paged_decode_attention`` (``_quant`` for an int8
    pool) reads the pool in place with ``kv_lens = lengths + 1`` (capped at
    NB*bs);
  * prefill chunk at ``cache_index = t0``: the first ceil((t0+C)/bs) pages
    of each row are gathered into a contiguous view (dequantized to the
    compute dtype in int8, as the reference does) and
    ``kernels.flash_attention`` attends over its first t0+C positions with
    right-aligned causal queries, the reference's
    ``kv_valid = kv_pos < cache_index + s``.

Every per-token index is derived on the device from device tensors of
fixed shape (``lengths``, ``block_tables``), so one forward issues the
same kernels whatever their values, and a CUDA graph can replay it.  A
write the reference's ``mode="drop"`` scatter drops (a decode write past
``max_len``, a paged write past the table or to a page id outside the
pool, such as the sentinel) is therefore decided by value: it goes to a
hidden scratch row (contiguous) or page (paged) that every cache leaf
carries in its storage past the (B,...) or (P,...) view that consumers
see (``with_scratch``).  Only dropped writes land there, so they can
never collide with a valid write in the same scatter, and no visible
entry changes.

The cache is updated in place (the reference returns a new pytree); the
per-forward index tensors are built once by ``attention_context`` or
``paged_attention_context`` and shared by every layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.inference.kv_quant import dequantize_kv, quantize_kv
from repro_torch.layers.common import apply_rope, dense_init, rope_tables

NEG_INF = -2.3819763e38  # large negative, bf16-safe (reference value)


def attention_init(gen, cfg: ModelConfig, device) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (d, hq * hd), cfg.pdtype, device),
        "wk": dense_init(gen, (d, hkv * hd), cfg.pdtype, device),
        "wv": dense_init(gen, (d, hkv * hd), cfg.pdtype, device),
        "wo": dense_init(gen, (hq * hd, d), cfg.pdtype, device),
    }
    if cfg.qkv_bias:
        # zeros, as the reference builds them
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros(width, dtype=cfg.pdtype, device=device)
    return p


def _zeros_with_scratch(shape, dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` as the first ``shape[0]`` entries of a buffer one
    entry longer: the hidden scratch entry that dropped writes go to."""
    return torch.zeros((shape[0] + 1, *shape[1:]), dtype=dtype,
                       device=device)[:shape[0]]


def with_scratch(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a cache leaf) extended by its hidden scratch entry along dim
    0: the same storage and strides, one more row (contiguous cache) or
    page (paged pool).  Raises for a tensor built without one."""
    n = t.shape[0] + 1
    need = t.storage_offset() + 1 + sum(
        (size - 1) * st for size, st in zip((n, *t.shape[1:]), t.stride()))
    if t.untyped_storage().nbytes() < need * t.element_size():
        raise ValueError(
            f"cache leaf {tuple(t.shape)} has no hidden scratch entry for "
            "dropped writes: build caches with make_cache / "
            "make_paged_cache")
    return t.as_strided((n, *t.shape[1:]), t.stride(), t.storage_offset())


def make_self_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": _zeros_with_scratch(shape, dtype, device),
            "v": _zeros_with_scratch(shape, dtype, device)}


def make_paged_self_cache(cfg: ModelConfig, num_pages: int, block_size: int,
                          dtype, device, quantized: bool = False) -> dict:
    """Pool-global paged KV: pages are shared by all slots via block tables
    (``repro_torch.kvcache``) rather than pre-carved per batch row.

    ``quantized``: int8 payload pages plus per-(token, head) f32 scale
    pages (``inference.kv_quant`` layout): hd + 4 bytes per (token, head)
    instead of 2*hd.  Each leaf is a (P, ...) view of P + 1 pages: page P
    is the hidden scratch page of dropped writes.
    """
    shape = (num_pages, block_size, cfg.n_kv_heads, cfg.hd)
    if quantized:
        return {"k_pages": _zeros_with_scratch(shape, torch.int8, device),
                "v_pages": _zeros_with_scratch(shape, torch.int8, device),
                "k_scale": _zeros_with_scratch(shape[:-1], torch.float32,
                                               device),
                "v_scale": _zeros_with_scratch(shape[:-1], torch.float32,
                                               device)}
    return {"k_pages": _zeros_with_scratch(shape, dtype, device),
            "v_pages": _zeros_with_scratch(shape, dtype, device)}


@dataclass
class AttnContext:
    """Per-forward indices shared by all layers."""
    rope: tuple                       # (cos, sin) for the S new tokens
    decode: bool                      # per-row lengths (one token per row)
    start: int = 0                    # prefill write offset
    kv_lens: Optional[torch.Tensor] = None   # (B,) int32, decode only
    # the writes (int64, so no scatter converts them), one per token, a
    # dropped one to the scratch entry: contiguous decode (row, position);
    # paged (page, offset) over B*S tokens
    pos: tuple = ()
    # paged cache only
    paged: bool = False
    block_tables: Optional[torch.Tensor] = None  # (B,NB) int32, decode
    gather: Optional[torch.Tensor] = None  # (B,n) pages a prefill reads
    kv_end: int = 0                   # positions a prefill attends over


def device_ints(x, shape, device) -> torch.Tensor:
    """``x`` (a device tensor, or host values) as an int32 tensor of
    ``shape`` on ``device``; host values cross in one copy."""
    if isinstance(x, torch.Tensor) and x.device == device:
        return x.to(torch.int32).reshape(shape)
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.int32).reshape(shape))
    return torch.from_numpy(arr).to(device)


def _multi_token_decode() -> NotImplementedError:
    return NotImplementedError(
        "multi-token decode with per-row lengths (speculative verify) is "
        "not ported yet, see ROADMAP Queue A, \"speculative decoding\"")


def attention_context(cfg: ModelConfig, b: int, s: int, device, *,
                      cache_index: int = 0, lengths=None,
                      max_len: Optional[int] = None) -> AttnContext:
    """Positions and cache-write indices for one forward.

    ``lengths`` (decode): (B,) per-row positions, a device tensor or host
    values.  Row b writes at ``(b, lengths[b])``; a write past ``max_len``
    goes to the hidden scratch row B instead (it drops, as in the
    reference).
    """
    if lengths is None:
        positions = torch.arange(cache_index, cache_index + s,
                                 device=device)[None].expand(b, s)
        return AttnContext(rope_tables(positions, cfg.hd, cfg.rope_theta),
                           decode=False, start=cache_index)
    if s != 1:
        raise _multi_token_decode()
    lens = device_ints(lengths, (b,), device)
    ok = lens < max_len
    rows = torch.where(ok, torch.arange(b, device=device), b)
    return AttnContext(
        rope_tables(lens[:, None], cfg.hd, cfg.rope_theta), decode=True,
        kv_lens=lens + 1, pos=(rows, torch.where(ok, lens, 0).long()))


def paged_attention_context(cfg: ModelConfig, b: int, s: int, device, *,
                            block_tables, n_pages: int, block_size: int,
                            cache_index: int = 0,
                            lengths=None) -> AttnContext:
    """Positions, page writes and page reads of one forward over the paged
    cache, from the (B,NB) ``block_tables`` and ``lengths`` (decode) or
    ``cache_index`` (prefill chunk), device tensors or host values.  A
    write whose block is past the table or whose page id is outside the
    pool goes to the hidden scratch page ``n_pages`` (it drops).  The
    chunk's ``cache_index`` is a host int: it sets how many pages the
    prefill gathers and how many positions it attends over."""
    bt = device_ints(block_tables, (b, -1), device)
    nb, bs = bt.shape[1], block_size
    if lengths is not None:
        if s != 1:
            raise _multi_token_decode()
        lens = device_ints(lengths, (b,), device)
        blk = lens // bs
        page = bt.gather(1, blk.clamp(max=nb - 1)[:, None].long())[:, 0]
        ok = (blk < nb) & (page >= 0) & (page < n_pages)
        return AttnContext(
            rope_tables(lens[:, None], cfg.hd, cfg.rope_theta), decode=True,
            kv_lens=(lens + 1).clamp(max=nb * bs),
            pos=(torch.where(ok, page, n_pages).long(), (lens % bs).long()),
            paged=True, block_tables=bt)
    cache_index = int(cache_index)
    end = cache_index + s
    n_read = -(-end // bs)
    if n_read > nb:
        raise ValueError(f"prefill writes [{cache_index}, {end}) past the "
                         f"table's {nb * bs} positions")
    pos = torch.arange(cache_index, end, device=device)
    page = bt[:, pos // bs]                               # (B,S)
    ok = (page >= 0) & (page < n_pages)
    return AttnContext(
        rope_tables(pos[None].expand(b, s), cfg.hd, cfg.rope_theta),
        decode=False, start=cache_index,
        pos=(torch.where(ok, page, n_pages).reshape(-1).long(),
             (pos % bs).repeat(b)),
        paged=True, gather=bt[:, :n_read].clamp(0, n_pages - 1).long(),
        kv_end=end)


def _paged_attention(q, k, v, cfg: ModelConfig, ctx: AttnContext,
                     cache: dict, scale: float, window: int):
    """Writes the new tokens into the pool, then attends; (B,S,HQ*hd)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    kp, vp = cache["k_pages"], cache["v_pages"]
    quantized = "k_scale" in cache
    k_new, v_new = k.reshape(b * s, hkv, hd), v.reshape(b * s, hkv, hd)
    page, off = ctx.pos
    if quantized:
        qk, sk = quantize_kv(k_new)
        qv, sv = quantize_kv(v_new)
        with_scratch(kp)[page, off] = qk
        with_scratch(vp)[page, off] = qv
        with_scratch(cache["k_scale"])[page, off] = sk
        with_scratch(cache["v_scale"])[page, off] = sv
    else:
        with_scratch(kp)[page, off] = k_new.to(kp.dtype)
        with_scratch(vp)[page, off] = v_new.to(vp.dtype)
    if ctx.decode:
        opts = dict(scale=scale, window=window, softcap=cfg.attn_softcap)
        if quantized:
            o = kernels.paged_decode_attention_quant(
                q[:, 0], kp, vp, cache["k_scale"], cache["v_scale"],
                ctx.block_tables, ctx.kv_lens, **opts)
        else:
            o = kernels.paged_decode_attention(
                q[:, 0], kp, vp, ctx.block_tables, ctx.kv_lens, **opts)
        return o.reshape(b, 1, hq * hd)
    ids, end = ctx.gather, ctx.kv_end
    kg = kp[ids].reshape(b, -1, hkv, hd)[:, :end]
    vg = vp[ids].reshape(b, -1, hkv, hd)[:, :end]
    if quantized:
        kg = dequantize_kv(kg, cache["k_scale"][ids].reshape(b, -1, hkv)
                           [:, :end], k.dtype)
        vg = dequantize_kv(vg, cache["v_scale"][ids].reshape(b, -1, hkv)
                           [:, :end], v.dtype)
    o = kernels.flash_attention(q.transpose(1, 2), kg.transpose(1, 2),
                                vg.transpose(1, 2), scale=scale,
                                causal=is_causal(cfg), window=window,
                                softcap=cfg.attn_softcap)
    return o.transpose(1, 2).reshape(b, s, hq * hd)


def is_causal(cfg: ModelConfig) -> bool:
    """An encoder-only family attends without the causal mask, as the
    reference's forward does."""
    return cfg.family != "encoder"


def _project(h, params, name: str, heads: int, hd: int, y=None):
    """``h @ w{name}`` (or its given product ``y``) plus ``b{name}`` when
    the layer has biases, as (B,S,heads,hd)."""
    if y is None:
        y = h @ params[f"w{name}"]
    bias = params.get(f"b{name}")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(h.shape[0], h.shape[1], heads, hd)


def attention_fwd(params, h, q, cfg: ModelConfig, ctx: AttnContext,
                  cache: Optional[dict] = None, window: int = 0):
    """Self-attention of one layer; returns its output (B,S,D).

    ``h``: the normed input (B,S,D); ``q``: its query projection
    ``h @ wq`` (B,S,HQ*hd) without bias, which the caller's fused
    RMSNorm+matmul kernel produced together with ``h``.  ``cache``: this
    layer's {"k","v"} (B,T,HKV,hd) or its pages
    (``make_paged_self_cache``, with a paged ``ctx``), updated in place.
    ``window``: the layer's sliding window (0: none).
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = cfg.attn_scale or hd ** -0.5
    b, s = h.shape[0], h.shape[1]
    q = apply_rope(_project(h, params, "q", hq, hd, y=q), ctx.rope)
    k = apply_rope(_project(h, params, "k", hkv, hd), ctx.rope)
    v = _project(h, params, "v", hkv, hd)

    if ctx.paged:
        return _paged_attention(q, k, v, cfg, ctx, cache, scale,
                                window) @ params["wo"]
    if ctx.decode:
        ck, cv = cache["k"], cache["v"]
        rows, pos = ctx.pos
        with_scratch(ck)[rows, pos] = k[:, 0].to(ck.dtype)
        with_scratch(cv)[rows, pos] = v[:, 0].to(cv.dtype)
        o = kernels.decode_attention(q[:, 0], ck.transpose(1, 2),
                                     cv.transpose(1, 2), ctx.kv_lens,
                                     scale=scale, window=window,
                                     softcap=cfg.attn_softcap)
        o = o.reshape(b, 1, hq * hd)
    else:
        if cache is not None:
            end = ctx.start + s
            if end > cache["k"].shape[1]:
                raise ValueError(f"prefill writes [{ctx.start}, {end}) past "
                                 f"the cache's {cache['k'].shape[1]} positions")
            cache["k"][:, ctx.start:end] = k.to(cache["k"].dtype)
            cache["v"][:, ctx.start:end] = v.to(cache["v"].dtype)
            k, v = cache["k"][:, :end], cache["v"][:, :end]
        o = kernels.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), scale=scale,
                                    causal=is_causal(cfg),
                                    window=window, softcap=cfg.attn_softcap)
        o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return o @ params["wo"]
