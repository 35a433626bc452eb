"""Transformer stacks: parameters, KV cache and forward.

Counterpart of ``repro/models/transformer.py`` for the block patterns
``("attn",)`` (dense GQA decoders such as SmolLM-360M, Llama-3.2-1B,
GPT-2, InternLM2 and CodeQwen1.5 with its qkv bias, and the encoder-only
BERT and XLM-R, which attend without the causal mask),
``("attn_local", "attn")`` (Gemma-2: sliding-window and global layers in
turn, soft-capped scores) and ``("rwkv6",)`` (RWKV-6, ``layers/rwkv.py``).
Layer i is of kind ``block_pattern[i % len(block_pattern)]``, and an
``attn_local`` layer attends over the last ``sliding_window`` positions.
The layer stack is a Python loop over per-layer parameter dicts
(``params["blocks"][i]``); ``bridge.params_from_jax`` unstacks the
reference's superblock axis into that list, superblock-major, then slot.

The forward computes the reference function, with its hot spots routed
through the hand-written kernels exactly where the reference's fused launch
plan substitutes its Pallas kernels (``repro/runtime/rules.py``).  Per
forward at L layers, for both attention patterns:

  * ``rmsnorm_matmul(x, norm1, wq) -> (q, h)``, L times (``h @ wk`` and
    ``h @ wv`` stay ``torch.matmul``; a q bias is added after the kernel);
  * ``decode_attention`` (decode), ``paged_decode_attention`` (decode over
    the paged pool; ``_quant`` in int8) or ``flash_attention`` (prefill and
    paged prefill chunks), L times, each with its layer's window and the
    config's softcap;
  * ``residual_rmsnorm(x, norm2, residual=attn_out)``, L times;
  * ``residual_rmsnorm(x, final_norm)``, once.

An RWKV-6 stack has no norm->single-matmul window; its norm windows sit on
the residual stream and go through the legacy two-output ``rmsnorm``, 2L+1
per forward: norm1 of layer 0 (no residual), norm2 with the time mix's
output as residual, norm1 of layer i > 0 with the previous channel mix's
output, and the final norm; plus ``wkv6`` L times.

The large plain products (wk, wv, wo, the MLP, the unembed) stay
``torch.matmul``, as the reference leaves them to XLA.

Each operator runs inside a ``torch.profiler.record_function`` scope named
as the reference's ``jax.named_scope`` (``layer{i}``, ``norm1``, ``attn``,
``rwkv``, ``norm2``, ``mlp``, ``rwkv_channel``, ``resid``, ``embed``,
``final_norm``, ``unembed``): a trace of the step (``core/tracing.py``)
reads them as each kernel's operator path, and the profiler tags the
device kernels with them.  The residual add the fused norm takes in
(``norm2``) is counted with the norm.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function as scope

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers import rwkv
from repro_torch.layers.common import (dense_init, embed_tokens, mlp_fwd,
                                       mlp_init, unembed)


PATTERNS = (("attn",), ("attn_local", "attn"), ("rwkv6",))
RECURRENT_KINDS = ("rwkv6", "mamba")


def is_recurrent(cfg: ModelConfig) -> bool:
    """True when the stack carries recurrent state (no positions, nothing
    to page): every token it is given runs through the recurrence."""
    return any(kind in RECURRENT_KINDS for kind in cfg.block_pattern)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for model features this slice of the port does not run:
    mixture-of-experts, an encoder-decoder stack, a frontend, and block
    patterns other than ``PATTERNS`` (cross-attention, Mamba, mixed
    stacks)."""
    if tuple(cfg.block_pattern) not in PATTERNS:
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} not ported yet, "
            "see ROADMAP Queue A, \"model features\"")
    unported = [name for name, on in (
        ("moe", cfg.moe is not None),
        ("n_encoder_layers", cfg.n_encoder_layers > 0),
        ("frontend", cfg.frontend != "none")) if on]
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {unported} not ported yet, see ROADMAP Queue A, "
            "\"model features\"")


def check_speculative(cfg: ModelConfig) -> None:
    """Raise for a stack whose greedy tokens a speculative verify cannot
    keep, as the reference's contract (every emitted token is the target's
    argmax from the true prefix) needs.  The reference speculates on both
    and its tokens then part from its own plain greedy ones (ROADMAP Queue
    C); the port refuses them."""
    if is_recurrent(cfg):
        raise ValueError(
            f"{cfg.name}: speculative decoding needs a stack whose verify "
            "can be rolled back; a recurrent stack's state advances through "
            "all k+1 verify tokens and a rejected draft token cannot be "
            "taken back out of it (the reference's speculative tokens part "
            "from its greedy ones: ROADMAP Queue C)")
    if cfg.family == "encoder":
        raise ValueError(
            f"{cfg.name}: speculative decoding needs causal attention; an "
            "encoder attends without the causal mask, so a verify query "
            "would see the draft tokens after it (the reference's "
            "speculative tokens part from its greedy ones: ROADMAP Queue C)")


def _layer_init(gen, cfg: ModelConfig, device) -> dict:
    ones = torch.ones(cfg.d_model, dtype=cfg.pdtype, device=device)
    if is_recurrent(cfg):
        mixer = rwkv.rwkv_time_init(gen, cfg, device)
        mlp = rwkv.rwkv_channel_init(gen, cfg, device)
    else:
        mixer = attn.attention_init(gen, cfg, device)
        mlp = mlp_init(gen, cfg, device)
    return {"norm1": {"scale": ones.clone()}, "mixer": mixer,
            "norm2": {"scale": ones.clone()}, "mlp": mlp}


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights drawn from ``generator`` (on its own device), placed
    on ``device``.  Same shapes and scales as the reference's init."""
    check_supported(cfg)
    dev = resolve_device(device)
    p = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                            cfg.pdtype, dev),
        "blocks": [_layer_init(generator, cfg, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": {"scale": torch.ones(cfg.d_model, dtype=cfg.pdtype,
                                           device=dev)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                  cfg.pdtype, dev)
    return p


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device="cuda") -> list:
    """Per-layer contiguous cache: [{"k","v"}: (B, T, HKV, hd)] * L, or for
    RWKV-6 [{"shift","shift_c"}: (B, D), "s": (B, H, hd, hd) f32] * L."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype
    if is_recurrent(cfg):
        return [rwkv.make_state(cfg, batch, dtype, dev)
                for _ in range(cfg.n_layers)]
    return [attn.make_self_cache(cfg, batch, max_len, dtype, dev)
            for _ in range(cfg.n_layers)]


def make_paged_cache(cfg: ModelConfig, num_pages: int, block_size: int,
                     dtype=None, kv_dtype: str = "bf16", *,
                     device="cuda") -> list:
    """Per-layer PAGED KV cache: per layer a pool of ``num_pages`` token
    pages shared across batch rows through block tables
    (``forward(..., block_tables=...)``): [{"k_pages","v_pages"}] * L,
    pages (P, bs, HKV, hd).  ``kv_dtype="int8"`` adds per-(token, head) f32
    ``"k_scale"``/``"v_scale"`` (P, bs, HKV) beside int8 pages; ``forward``
    dispatches on them.  ``check_supported`` rejects every stack the port
    does not run; a recurrent stack raises ``ValueError``, as the
    reference's does: its state is O(1) per slot and has nothing to page."""
    check_supported(cfg)
    if is_recurrent(cfg):
        raise ValueError(
            "paged KV cache supports pure-attention stacks only; "
            f"{cfg.name} has block kinds {list(cfg.block_pattern)}")
    dev = resolve_device(device)
    return [attn.make_paged_self_cache(cfg, num_pages, block_size,
                                       dtype or cfg.cdtype, dev,
                                       quantized=(kv_dtype == "int8"))
            for _ in range(cfg.n_layers)]


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer i's sliding window: ``sliding_window`` on an ``attn_local``
    layer, else 0 (global)."""
    kind = cfg.block_pattern[i % len(cfg.block_pattern)]
    return cfg.sliding_window if kind == "attn_local" else 0


def forward(params, tokens, cfg: ModelConfig, *, cache: Optional[list] = None,
            cache_index: int = 0, lengths=None, block_tables=None,
            positions=None):
    """Returns (logits f32 (B,S,V), cache).

    ``cache``: from ``make_cache`` or ``make_paged_cache``, updated in place
    (and returned).
    ``cache_index``: prefill write offset (no ``lengths``).
    ``lengths``: (B,) per-row positions for continuous-batching decode, a
    device tensor or host values; row b's token is written at
    ``lengths[b]`` and attends to positions ``<= lengths[b]``.  A write
    past the cache is dropped, as in the reference.
    With S > 1 tokens a row (the speculative verify), row b's tokens are
    written at ``positions[b]`` (B,S), by default ``lengths[b] + 0..S-1``
    as in the reference, and token j attends to the row's positions up to
    its own (``check_speculative`` refuses the stacks where that differs
    from the reference's function or from its greedy tokens).
    ``positions``: explicit per-token positions with ``lengths`` (the
    speculative draft's steps; a padding column at ``max_len`` drops its
    write).
    ``block_tables``: (B,NB) page ids of a paged cache, a device tensor or
    host values; writes past the table or to the sentinel page drop.
    With ``tokens``, ``lengths`` and ``block_tables`` on the device the
    forward derives every index there and issues the same kernels for any
    values (``inference.backends.local`` captures it as a CUDA graph).
    """
    check_supported(cfg)
    embed = params["embed"]
    dev = embed.device
    tokens = torch.as_tensor(tokens).to(dev)
    b, s = tokens.shape
    if lengths is not None and cache is None:
        raise ValueError("lengths= (decode) needs a cache")
    if lengths is not None and s > 1:
        check_speculative(cfg)
    if is_recurrent(cfg):
        if block_tables is not None:
            raise ValueError(f"{cfg.name}: a recurrent stack has no paged "
                             "cache (block_tables=)")
        return _forward_rwkv(params, tokens, cfg, cache), cache
    paged = cache is not None and "k_pages" in cache[0]
    if paged != (block_tables is not None):
        raise ValueError("a paged cache needs block_tables=, and "
                         "block_tables= needs a paged cache")
    if paged:
        n_pages, bs = cache[0]["k_pages"].shape[:2]
        ctx = attn.paged_attention_context(
            cfg, b, s, dev, block_tables=block_tables, n_pages=n_pages,
            block_size=bs, cache_index=cache_index, lengths=lengths,
            positions=positions)
    else:
        max_len = cache[0]["k"].shape[1] if cache is not None else None
        ctx = attn.attention_context(cfg, b, s, dev, cache_index=cache_index,
                                     lengths=lengths, positions=positions,
                                     max_len=max_len)
    eps = cfg.norm_eps
    with scope("embed"):
        x = embed_tokens(embed, tokens, cfg).to(cfg.cdtype)
    for i, bp in enumerate(params["blocks"]):
        with scope(f"layer{i}"):
            with scope("norm1"):
                q, h = kernels.rmsnorm_matmul(x, bp["norm1"]["scale"],
                                              bp["mixer"]["wq"], eps=eps)
            with scope("attn"):
                o = attn.attention_fwd(
                    bp["mixer"], h, q, cfg, ctx,
                    cache=None if cache is None else cache[i],
                    window=layer_window(cfg, i))
            with scope("norm2"):
                h, x = kernels.residual_rmsnorm(x, bp["norm2"]["scale"],
                                                residual=o, eps=eps)
            with scope("mlp"):
                m = mlp_fwd(bp["mlp"], h, cfg)
            with scope("resid"):
                x = x + m
    with scope("final_norm"):
        x, _ = kernels.residual_rmsnorm(x, params["final_norm"]["scale"],
                                        eps=eps)
    with scope("unembed"):
        return unembed(x, embed, params.get("lm_head"), cfg), cache


def _forward_rwkv(params, tokens, cfg: ModelConfig, cache):
    """RWKV-6 logits (B,S,V) f32.  Every row runs the recurrence from its
    cache state; there are no positions, so ``cache_index`` and
    ``lengths`` have nothing to select (free slots step too, as in the
    reference).  The norms fuse each residual add into the next norm."""
    eps = cfg.norm_eps
    with scope("embed"):
        x = embed_tokens(params["embed"], tokens, cfg).to(cfg.cdtype)
    res = None
    for i, bp in enumerate(params["blocks"]):
        state = None if cache is None else cache[i]
        with scope(f"layer{i}"):
            with scope("norm1"):
                h, x = kernels.rmsnorm(x, bp["norm1"]["scale"], residual=res,
                                       eps=eps)
            with scope("rwkv"):
                o = rwkv.rwkv_time_fwd(bp["mixer"], h, cfg, state)
            with scope("norm2"):
                h, x = kernels.rmsnorm(x, bp["norm2"]["scale"], residual=o,
                                       eps=eps)
            with scope("rwkv_channel"):
                res = rwkv.rwkv_channel_fwd(bp["mlp"], h, cfg, state)
    with scope("final_norm"):
        x, _ = kernels.rmsnorm(x, params["final_norm"]["scale"],
                               residual=res, eps=eps)
    with scope("unembed"):
        return unembed(x, params["embed"], params.get("lm_head"), cfg)
