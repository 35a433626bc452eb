"""Causal GQA self-attention over a contiguous or a paged KV cache.

Counterpart of the self-attention paths of ``attention_fwd`` in
``repro/layers/attention.py`` (cross-attention and sharding come with
later slices; see ROADMAP).  Where the reference computes attention in
plain XLA, the port routes it through its hand-written kernels.

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

  * writes: each new token's page ``bt[b, t // bs]`` and offset ``t % bs``
    are worked out on the host from the engine's numpy table and lengths;
    writes whose block is past the table or whose page id is out of the
    pool (the sentinel) are dropped there, as the reference's
    ``mode="drop"`` scatter drops them.  An int8 pool quantizes on write;
  * decode: ``kernels.paged_decode_attention`` (``_quant`` for an int8
    pool) reads the pool in place with ``kv_lens = lengths + 1`` (capped at
    NB*bs);
  * prefill chunk at ``cache_index = t0``: the first ceil((t0+C)/bs) pages
    of each row are gathered into a contiguous view (dequantized to the
    compute dtype in int8, as the reference does) and
    ``kernels.flash_attention`` attends over its first t0+C positions with
    right-aligned causal queries, the reference's
    ``kv_valid = kv_pos < cache_index + s``.

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
    return {
        "wq": dense_init(gen, (d, hq * hd), cfg.pdtype, device),
        "wk": dense_init(gen, (d, hkv * hd), cfg.pdtype, device),
        "wv": dense_init(gen, (d, hkv * hd), cfg.pdtype, device),
        "wo": dense_init(gen, (hq * hd, d), cfg.pdtype, device),
    }


def make_self_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def make_paged_self_cache(cfg: ModelConfig, num_pages: int, block_size: int,
                          dtype, device, quantized: bool = False) -> dict:
    """Pool-global paged KV: pages are shared by all slots via block tables
    (``repro_torch.kvcache``) rather than pre-carved per batch row.

    ``quantized``: int8 payload pages plus per-(token, head) f32 scale
    pages (``inference.kv_quant`` layout): hd + 4 bytes per (token, head)
    instead of 2*hd.
    """
    shape = (num_pages, block_size, cfg.n_kv_heads, cfg.hd)
    if quantized:
        return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)}
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


@dataclass
class AttnContext:
    """Per-forward indices shared by all layers."""
    rope: tuple                       # (cos, sin) for the S new tokens
    decode: bool                      # per-row lengths (one token per row)
    start: int = 0                    # prefill write offset
    kv_lens: Optional[torch.Tensor] = None   # (B,) int32, decode only
    rows: Optional[torch.Tensor] = None      # rows (paged: tokens) written
    pos: object = None                # their positions (paged: page, offset)
    all_rows: bool = True             # every row's write lands
    # paged cache only
    paged: bool = False
    block_tables: Optional[torch.Tensor] = None  # (B,NB) int32, decode
    gather: Optional[torch.Tensor] = None  # (B,n) pages a prefill reads
    kv_end: int = 0                   # positions a prefill attends over


def attention_context(cfg: ModelConfig, b: int, s: int, device, *,
                      cache_index: int = 0, lengths=None,
                      max_len: Optional[int] = None) -> AttnContext:
    """Positions and cache-write indices for one forward.

    ``lengths`` (decode) is best given as a host array: the positions are
    then known on the host, writes past ``max_len`` are dropped there (as
    the reference's ``mode="drop"`` scatter drops them), and all per-row
    indices reach the device in one copy.
    """
    if lengths is None:
        positions = torch.arange(cache_index, cache_index + s,
                                 device=device)[None].expand(b, s)
        return AttnContext(rope_tables(positions, cfg.hd, cfg.rope_theta),
                           decode=False, start=cache_index)
    if s != 1:
        raise NotImplementedError(
            "multi-token decode with per-row lengths (speculative verify) "
            "is not ported yet, see ROADMAP Queue A, \"speculative "
            "decoding\"")
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu()
    lens = np.asarray(lengths, dtype=np.int64).reshape(b)
    valid = np.flatnonzero(lens < max_len)
    pack = np.zeros((4, b), np.int32)
    pack[0] = lens                                  # positions
    pack[1] = lens + 1                              # kv_lens
    pack[2, :len(valid)] = valid                    # rows written
    pack[3, :len(valid)] = lens[valid]              # where
    dev = torch.from_numpy(pack).to(device)
    return AttnContext(
        rope_tables(dev[0][:, None], cfg.hd, cfg.rope_theta), decode=True,
        kv_lens=dev[1], rows=dev[2, :len(valid)], pos=dev[3, :len(valid)],
        all_rows=len(valid) == b)


def paged_attention_context(cfg: ModelConfig, b: int, s: int, device, *,
                            block_tables, n_pages: int, block_size: int,
                            cache_index: int = 0,
                            lengths=None) -> AttnContext:
    """Positions, page writes and page reads of one forward over the paged
    cache, from the host's (B,NB) ``block_tables`` and ``lengths`` (decode)
    or ``cache_index`` (prefill chunk).  A write whose block is past the
    table or whose page id is outside the pool is dropped here; every index
    reaches the device in one copy.  ``rows``/``pos`` hold the writes: the
    token (flattened over B*S) and its (page, offset) as ``pos[0]``,
    ``pos[1]``."""
    if isinstance(block_tables, torch.Tensor):
        block_tables = block_tables.cpu()
    bt = np.asarray(block_tables, dtype=np.int64).reshape(b, -1)
    nb, bs = bt.shape[1], block_size
    if lengths is not None:
        if s != 1:
            raise NotImplementedError(
                "multi-token decode with per-row lengths (speculative "
                "verify) is not ported yet, see ROADMAP Queue A, "
                "\"speculative decoding\"")
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.cpu()
        start = np.asarray(lengths, dtype=np.int64).reshape(b, 1)
    else:
        cache_index = int(cache_index)
        start = np.full((b, 1), cache_index, np.int64)
    positions = start + np.arange(s)                     # (B,S)
    blk = positions // bs
    page = np.take_along_axis(bt, np.minimum(blk, nb - 1), axis=1)
    ok = (blk < nb) & (page >= 0) & (page < n_pages)
    src = np.flatnonzero(ok.ravel())
    writes = [src, page.ravel()[src], (positions % bs).ravel()[src]]
    if lengths is not None:
        kv_lens = np.minimum(start[:, 0] + 1, nb * bs)
        parts = [start[:, 0], kv_lens, *writes, bt.ravel()]
    else:
        end = cache_index + s
        n_read = -(-end // bs)
        if n_read > nb:
            raise ValueError(f"prefill writes [{cache_index}, {end}) past "
                             f"the table's {nb * bs} positions")
        parts = [*writes, np.clip(bt[:, :n_read], 0, n_pages - 1).ravel()]
    sizes = [len(p) for p in parts]
    dev = torch.from_numpy(
        np.concatenate(parts).astype(np.int32)).to(device).split(sizes)
    n_w = len(src)
    if lengths is not None:
        lens, kv_lens, w_src, w_page, w_off, bt_dev = dev
        return AttnContext(
            rope_tables(lens[:, None], cfg.hd, cfg.rope_theta), decode=True,
            kv_lens=kv_lens, rows=w_src, pos=(w_page, w_off),
            all_rows=n_w == b, paged=True,
            block_tables=bt_dev.reshape(b, nb))
    w_src, w_page, w_off, gather = dev
    pos = torch.arange(cache_index, cache_index + s,
                       device=device)[None].expand(b, s)
    return AttnContext(
        rope_tables(pos, cfg.hd, cfg.rope_theta), decode=False,
        start=cache_index, rows=w_src, pos=(w_page, w_off),
        all_rows=n_w == b * s, paged=True, gather=gather.reshape(b, -1),
        kv_end=cache_index + s)


def _paged_attention(q, k, v, cfg: ModelConfig, ctx: AttnContext,
                     cache: dict, scale: float):
    """Writes the new tokens into the pool, then attends; (B,S,HQ*hd)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    kp, vp = cache["k_pages"], cache["v_pages"]
    quantized = "k_scale" in cache
    k_new, v_new = k.reshape(b * s, hkv, hd), v.reshape(b * s, hkv, hd)
    if not ctx.all_rows:
        k_new, v_new = k_new[ctx.rows], v_new[ctx.rows]
    page, off = ctx.pos
    if quantized:
        qk, sk = quantize_kv(k_new)
        qv, sv = quantize_kv(v_new)
        kp[page, off] = qk
        vp[page, off] = qv
        cache["k_scale"][page, off] = sk
        cache["v_scale"][page, off] = sv
    else:
        kp[page, off] = k_new.to(kp.dtype)
        vp[page, off] = v_new.to(vp.dtype)
    if ctx.decode:
        if quantized:
            o = kernels.paged_decode_attention_quant(
                q[:, 0], kp, vp, cache["k_scale"], cache["v_scale"],
                ctx.block_tables, ctx.kv_lens, scale=scale)
        else:
            o = kernels.paged_decode_attention(
                q[:, 0], kp, vp, ctx.block_tables, ctx.kv_lens, scale=scale)
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
                                vg.transpose(1, 2), scale=scale, causal=True,
                                softcap=cfg.attn_softcap)
    return o.transpose(1, 2).reshape(b, s, hq * hd)


def attention_fwd(params, h, q, cfg: ModelConfig, ctx: AttnContext,
                  cache: Optional[dict] = None):
    """Self-attention of one layer; returns its output (B,S,D).

    ``h``: the normed input (B,S,D); ``q``: its query projection
    ``h @ wq`` (B,S,HQ*hd), which the caller's fused RMSNorm+matmul kernel
    produced together with ``h``.  ``cache``: this layer's {"k","v"}
    (B,T,HKV,hd) or its pages (``make_paged_self_cache``, with a paged
    ``ctx``), updated in place.
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = cfg.attn_scale or hd ** -0.5
    b, s = h.shape[0], h.shape[1]
    q = apply_rope(q.reshape(b, s, hq, hd), ctx.rope)
    k = apply_rope((h @ params["wk"]).reshape(b, s, hkv, hd), ctx.rope)
    v = (h @ params["wv"]).reshape(b, s, hkv, hd)

    if ctx.paged:
        return _paged_attention(q, k, v, cfg, ctx, cache, scale) @ params["wo"]
    if ctx.decode:
        ck, cv = cache["k"], cache["v"]
        k_new, v_new = k[:, 0], v[:, 0]
        if not ctx.all_rows:
            k_new, v_new = k_new[ctx.rows], v_new[ctx.rows]
        ck[ctx.rows, ctx.pos] = k_new.to(ck.dtype)
        cv[ctx.rows, ctx.pos] = v_new.to(cv.dtype)
        o = kernels.decode_attention(q[:, 0], ck.transpose(1, 2),
                                     cv.transpose(1, 2), ctx.kv_lens,
                                     scale=scale)
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
                                    causal=True, softcap=cfg.attn_softcap)
        o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return o @ params["wo"]
