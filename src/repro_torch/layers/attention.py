"""Causal GQA self-attention over a contiguous KV cache.

Counterpart of the contiguous self-attention path of ``attention_fwd`` in
``repro/layers/attention.py`` (paged, cross-attention and sharding come
with later slices; see ROADMAP).  Where the reference computes attention in
plain XLA, the port routes it through its hand-written kernels:

  * decode (one new token per row, per-row ``lengths``): the token's K/V
    are written at ``lengths[b]`` and ``kernels.decode_attention`` reads the
    (B,T,HKV,hd) cache in place through a transposed view, with per-row
    ``kv_lens = lengths + 1``;
  * prefill at ``cache_index`` (and a forward without cache): K/V are
    written to ``[cache_index, cache_index + S)`` and
    ``kernels.flash_attention`` attends over the first ``cache_index + S``
    positions, queries right-aligned, so a prefill from 0 attends over the
    prompt's own K/V (T = S, ``q_offset`` 0).

The cache is updated in place (the reference returns a new pytree); the
per-forward index tensors are built once by ``attention_context`` and
shared by every layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
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


@dataclass
class AttnContext:
    """Per-forward indices shared by all layers."""
    rope: tuple                       # (cos, sin) for the S new tokens
    decode: bool                      # per-row lengths (one token per row)
    start: int = 0                    # prefill write offset
    kv_lens: Optional[torch.Tensor] = None   # (B,) int32, decode only
    rows: Optional[torch.Tensor] = None      # rows whose write lands
    pos: Optional[torch.Tensor] = None       # their write positions
    all_rows: bool = True             # every row's write lands


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
            "is not ported yet, see ROADMAP Queue A item 7")
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


def attention_fwd(params, h, q, cfg: ModelConfig, ctx: AttnContext,
                  cache: Optional[dict] = None):
    """Self-attention of one layer; returns its output (B,S,D).

    ``h``: the normed input (B,S,D); ``q``: its query projection
    ``h @ wq`` (B,S,HQ*hd), which the caller's fused RMSNorm+matmul kernel
    produced together with ``h``.  ``cache``: this layer's {"k","v"}
    (B,T,HKV,hd), updated in place.
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = cfg.attn_scale or hd ** -0.5
    b, s = h.shape[0], h.shape[1]
    q = apply_rope(q.reshape(b, s, hq, hd), ctx.rope)
    k = apply_rope((h @ params["wk"]).reshape(b, s, hkv, hd), ctx.rope)
    v = (h @ params["wv"]).reshape(b, s, hkv, hd)

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
