"""Transformer stacks: parameters, cache and forward.

Counterpart of ``repro/models/transformer.py`` for every stack of attention
(``attn``; ``attn_local``: sliding window), Mamba and RWKV-6 layers, with
a dense or a mixture-of-experts MLP: dense GQA decoders (SmolLM-360M,
Llama-3.2-1B, GPT-2, InternLM2, CodeQwen1.5 with its qkv bias), the
encoder-only BERT and XLM-R (no causal mask), Gemma-2 (``("attn_local",
"attn")``, soft-capped scores), the MoE decoders Moonlight-16B-A3B and
Kimi K2 (``layers/moe.py``), the Jamba hybrid (Mamba layers, ``layers/
mamba.py``, around one attention slot, MoE in the odd slots), RWKV-6
(``("rwkv6",)``, ``layers/rwkv.py``; an RWKV-6 slot also runs beside any
other kind, as the reference's ``_apply_slot`` takes it) and the
cross-attention stacks:
Llama-3.2-Vision (an ``xattn`` layer, gated by ``tanh(xgate)``, every
fifth layer, over image-patch states) and the SeamlessM4T encoder-decoder
(``n_encoder_layers`` non-causal encoder layers, ``params["enc_blocks"]``
and ``enc_norm``; every decoder layer cross-attends to the encoder's
output after its self-attention, through ``norm_x`` and ``xattn``).
The frontends are stubs, as in the reference: ``forward`` takes the patch
embeddings (``frontend_embeds=``) or the frame embeddings
(``encoder_tokens=``, run through the encoder) as (B,T,D) arrays.
Layer i is of kind
``block_pattern[i % len(block_pattern)]`` and carries ``moe`` instead of
``mlp`` when ``i % len(block_pattern)`` is in ``moe_slots``.  The layer
stack is a Python loop over per-layer parameter dicts
(``params["blocks"][i]``, the encoder's ``params["enc_blocks"][i]``);
``bridge.params_from_jax`` unstacks the reference's superblock axis into
that list, superblock-major, then slot.

The forward computes the reference function, with its hot spots routed
through the hand-written kernels exactly where the reference's fused launch
plan substitutes its Pallas kernels (``repro/runtime/rules.py``).  Per
forward at L layers, A of them attention and M Mamba:

  * ``rmsnorm_matmul(x, norm1, wq) -> (q, h)`` on an attention layer
    (``h @ wk`` and ``h @ wv`` stay ``torch.matmul``; a q bias is added
    after the kernel), ``rmsnorm_matmul(x, norm1, in_proj) -> (xz, h)`` on
    a Mamba layer: A + M times;
  * ``decode_attention`` (decode), ``paged_decode_attention`` (decode over
    the paged pool; ``_quant`` in int8) or ``flash_attention`` (prefill and
    paged prefill chunks), A times, each with its layer's window and the
    config's softcap;
  * ``residual_rmsnorm(x, norm2, residual=mixer_out)``, L times: before a
    MoE the norm's output is reshaped to (T, D) first, so no product
    follows it directly and the reference's plan fuses the residual add;
  * on an encoder-decoder's decoder layer, ``residual_rmsnorm(x, norm_x,
    residual=self_attention_out)`` once more (its ``wq`` product plain),
    and the cross-attention's ``decode_attention`` (decode) or
    ``flash_attention`` (otherwise, non-causal over all T source
    positions) beside the self-attention's; an ``xattn`` layer's
    cross-attention takes its attention kernel the same way;
  * with ``encoder_tokens``, the encoder: per layer ``rmsnorm_matmul`` (its
    norm1 with wq), ``flash_attention`` (non-causal, S = T) and
    ``residual_rmsnorm`` (norm2), and ``residual_rmsnorm(x, enc_norm,
    residual=last_mlp_out)`` once;
  * ``rmsnorm_matmul(x, final_norm, lm_head) -> (logits, h)`` once on an
    untied stack (the unembed's product), ``residual_rmsnorm(x,
    final_norm)`` once on a tied one.

An RWKV-6 layer has no norm->single-matmul window (its token shift comes
before its first product).  The pure RWKV-6 stack runs its own loop, whose
norm windows sit on the residual stream and go through the legacy
two-output ``rmsnorm``, 2L+1 per forward: norm1 of layer 0 (no residual),
norm2 with the time mix's output as residual, norm1 of layer i > 0 with the
previous channel mix's output, and the final norm; plus ``wkv6`` L times.
In a stack that mixes it with other kinds an RWKV-6 slot runs in the
general loop: ``wkv6`` once, its norm1 a ``residual_rmsnorm`` (without a
residual at a superblock's first slot), its norm2 a ``residual_rmsnorm``
before the channel mix (``models.norm_launches``).

The large plain products (wk, wv, wo, the MLP, the experts, Mamba's
projections, a tied unembed) stay ``torch.matmul``/``bmm``, as the reference
leaves them to XLA; so do the router, the dispatch and Mamba's conv and
scan.

Each operator runs inside a ``torch.profiler.record_function`` scope named
as the reference's ``jax.named_scope`` (``layer{i}``, ``norm1``, ``attn``,
``mamba``, ``rwkv``, ``xattn`` (an ``xattn`` layer's mixer, and an
encoder-decoder layer's cross-attention with its ``norm_x``), ``norm2``,
``mlp``, ``moe``, ``rwkv_channel``, ``resid``, ``embed``, ``final_norm``,
``unembed``; the encoder's layers as the decoder's, its ``enc_norm``
outside any): a trace of the step
(``core/tracing.py``) reads them as each kernel's operator path, and the
profiler tags the device kernels with them.  The residual add the fused
norm takes in (``norm2``) is counted with the norm.

Training (``loss_fn``, the reference's): the forward without cache, the
same kernels, with the MoE aux loss summed over the layers
(``with_aux``), optionally the final hidden states for a chunked CE
(``return_hidden``) and each layer recomputed in the backward
(``remat``, ``torch.utils.checkpoint`` under one of ``REMAT_POLICIES``).
The kernels' custom ops carry closed-form backward rules
(``kernels/*/backward.py``), so the backward is torch ops and launches no
hand-written kernel (with remat, the recomputed forward launches them
again).  An RWKV-6 stack trains through ``wkv6``'s functional entry,
whose closed-form backward (``kernels/rwkv6/backward.py``) follows the
chunked recurrence.

Multi-rank training (``distributed``): ``forward`` and ``loss_fn`` take
``dist``, the MoE layers' mesh context inside a rank (expert parallelism),
as the reference's; ``forward_blocks`` runs a contiguous range of layers
on the residual stream, and ``stage_forward`` over ``pipeline_stages``
is a pipeline stage's ``stage_fn`` (each stage keeps its first layer's
index).

Tensor parallelism inside a rank (``tp``, ``launch.steps.RankTP``): the
step builders run every layer head-, d_ff- or d_inner-parallel over the
mesh's model axis.  ``cfg`` then carries the rank's head counts, ``params``
the rank's working tree (its slices, and whole what it gathered), and the
forward asks ``tp`` at each region: ``tp.partial(kind)`` (the region's
output is this rank's partial sum: its input enters through
``tp.enter``, whose gradient is summed over the model axis, and its
output leaves through ``tp.reduce``), ``tp.embed`` (the vocabulary-split
lookup), ``tp.logits`` / ``tp.ce_sum`` (the rank's vocabulary block and
the vocabulary-parallel CE), ``tp.seq_gather`` / ``tp.seq_scatter``
(with ``seq_shard``: the residual stream between superblocks is the
rank's block of S), ``tp.kv_sel`` and ``tp.seq_split`` (the attention's
kv-head read and a sequence-split cache), ``tp.wkv`` (RWKV's batch
over-shard).  None: every layer whole, as on one device.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint as torch_checkpoint
from torch.profiler import record_function as scope

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers import mamba
from repro_torch.layers import moe
from repro_torch.layers import rwkv
from repro_torch.layers.common import (dense_init, embed_tokens, mlp_fwd,
                                       mlp_init, softcap, unembed)
from repro_torch.tree import leaves, named_leaves


ATTENTION_KINDS = ("attn", "attn_local")
RECURRENT_KINDS = ("rwkv6", "mamba")
# the reference's jax.named_scope tag of each mixer kind (_MIXER_SCOPE)
MIXER_SCOPE = {"attn": "attn", "attn_local": "attn", "xattn": "xattn",
               "mamba": "mamba", "rwkv6": "rwkv"}


def layer_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.block_pattern[i % len(cfg.block_pattern)]


def layer_has_moe(cfg: ModelConfig, i: int) -> bool:
    """Layer i's MLP is a mixture of experts (its pattern slot is in
    ``moe_slots``), as the reference's ``_slot_init`` decides."""
    return (cfg.moe is not None
            and i % len(cfg.block_pattern) in cfg.moe_slots)


def is_recurrent(cfg: ModelConfig) -> bool:
    """True when the stack carries recurrent state (RWKV-6, or Mamba layers
    in a hybrid): every token it is given runs through the recurrence, so
    a prefill takes exactly the prompt, nothing pages and no verify rolls
    back."""
    return any(kind in RECURRENT_KINDS for kind in cfg.block_pattern)


def has_cross(cfg: ModelConfig) -> bool:
    """True when the stack cross-attends: an ``xattn`` layer, or the
    decoder of an encoder-decoder."""
    return "xattn" in cfg.block_pattern or cfg.n_encoder_layers > 0


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config, as the reference builds it: one ``attn`` slot
    a layer, no MoE."""
    return cfg.replace(block_pattern=("attn",), moe_slots=())


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block kind the reference does not know; any known kind
    runs in any slot, as the reference's ``_apply_slot`` takes it."""
    unknown = set(cfg.block_pattern) - set(MIXER_SCOPE)
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")


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


def _layer_init(gen, cfg: ModelConfig, i: int, device,
                decoder: bool = True) -> dict:
    ones = torch.ones(cfg.d_model, dtype=cfg.pdtype, device=device)
    kind = layer_kind(cfg, i)
    if kind == "rwkv6":
        mixer = rwkv.rwkv_time_init(gen, cfg, device)
    elif kind == "mamba":
        mixer = mamba.mamba_init(gen, cfg, device)
    else:
        mixer = attn.attention_init(gen, cfg, device,
                                    cross=kind == "xattn")
    p = {"norm1": {"scale": ones.clone()}, "mixer": mixer,
         "norm2": {"scale": ones.clone()}}
    if kind == "xattn":
        # tanh(0) = 0, as the reference initialises it: a fresh cross
        # layer passes its input through unchanged
        p["xgate"] = torch.zeros((), dtype=torch.float32, device=device)
    if decoder and cfg.n_encoder_layers and kind != "xattn":
        # enc-dec decoder: every layer also cross-attends to the encoder
        p["norm_x"] = {"scale": ones.clone()}
        p["xattn"] = attn.attention_init(gen, cfg, device, cross=True)
    if kind == "rwkv6":
        p["mlp"] = rwkv.rwkv_channel_init(gen, cfg, device)
    elif layer_has_moe(cfg, i):
        p["moe"] = moe.moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights drawn from ``generator`` (on its own device), placed
    on ``device``.  Same shapes and scales as the reference's init."""
    check_supported(cfg)
    dev = resolve_device(device)
    p = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                            cfg.pdtype, dev),
        "blocks": [_layer_init(generator, cfg, i, dev)
                   for i in range(cfg.n_layers)],
        "final_norm": {"scale": torch.ones(cfg.d_model, dtype=cfg.pdtype,
                                           device=dev)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                  cfg.pdtype, dev)
    if cfg.n_encoder_layers:
        enc = encoder_config(cfg)
        p["enc_blocks"] = [_layer_init(generator, enc, i, dev, decoder=False)
                           for i in range(cfg.n_encoder_layers)]
        p["enc_norm"] = {"scale": torch.ones(cfg.d_model, dtype=cfg.pdtype,
                                             device=dev)}
    return p


def make_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int = 0,
               *, dtype=None, device="cuda") -> list:
    """Per-layer contiguous cache, one dict a layer: an attention layer's
    {"k","v"}: (B, T, HKV, hd); a Mamba layer's {"conv": (B, d_conv-1,
    d_inner), "h": (B, d_inner, d_state) f32}; an RWKV-6 layer's
    {"shift","shift_c"}: (B, D), "s": (B, H, hd, hd) f32.  A layer that
    cross-attends (an ``xattn`` layer, every decoder layer of an
    encoder-decoder) also holds {"cross_k","cross_v"}: (B, src_len, HKV,
    hd), the reference's ``"cross"`` cache."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype
    makers = {"rwkv6": lambda: rwkv.make_state(cfg, batch, dtype, dev),
              "mamba": lambda: mamba.make_state(cfg, batch, dtype, dev),
              "xattn": dict}

    def layer(i):
        kind = layer_kind(cfg, i)
        c = makers.get(kind, lambda: attn.make_self_cache(
            cfg, batch, max_len, dtype, dev))()
        if kind == "xattn" or cfg.n_encoder_layers:
            cross = attn.make_cross_cache(cfg, batch, src_len, dtype, dev)
            c["cross_k"], c["cross_v"] = cross["k"], cross["v"]
        return c
    return [layer(i) for i in range(cfg.n_layers)]


def make_paged_cache(cfg: ModelConfig, num_pages: int, block_size: int,
                     dtype=None, kv_dtype: str = "bf16", *,
                     device="cuda") -> list:
    """Per-layer PAGED KV cache: per layer a pool of ``num_pages`` token
    pages shared across batch rows through block tables
    (``forward(..., block_tables=...)``): [{"k_pages","v_pages"}] * L,
    pages (P, bs, HKV, hd).  ``kv_dtype="int8"`` adds per-(token, head) f32
    ``"k_scale"``/``"v_scale"`` (P, bs, HKV) beside int8 pages; ``forward``
    dispatches on them.  ``check_supported`` rejects every stack the port
    does not run; a stack with recurrent layers raises ``ValueError``, as
    the reference's does: its state is O(1) per slot and has nothing to
    page.  So do a cross-attention stack (its ``xattn`` layers) and an
    encoder-decoder, with the reference's words."""
    check_supported(cfg)
    unsupported = [k for k in cfg.block_pattern if k not in ATTENTION_KINDS]
    if unsupported:
        raise ValueError(
            "paged KV cache supports pure-attention stacks only; "
            f"{cfg.name} has block kinds {unsupported}")
    if cfg.n_encoder_layers:
        raise ValueError("paged KV cache does not support enc-dec models")
    dev = resolve_device(device)
    return [attn.make_paged_self_cache(cfg, num_pages, block_size,
                                       dtype or cfg.cdtype, dev,
                                       quantized=(kv_dtype == "int8"))
            for _ in range(cfg.n_layers)]


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer i's sliding window: ``sliding_window`` on an ``attn_local``
    layer, else 0 (global)."""
    return cfg.sliding_window if layer_kind(cfg, i) == "attn_local" else 0


def norm_launches(cfg: ModelConfig, encoder: bool = False) -> dict:
    """The norm kernels one forward launches.  The pure RWKV-6 stack:
    the legacy ``rmsnorm`` 2L + 1 times.  Any other: ``rmsnorm_matmul``
    once a superblock (its first slot's norm1 with the mixer's input
    product) unless that slot is RWKV-6, whose token shift comes first, so
    its norm1 is a ``residual_rmsnorm`` without a residual (the reference's
    plan lowers that bare ``rmsnorm`` window to the same kernel);
    ``residual_rmsnorm`` at every norm2 and at the norm1 of every later
    slot (the previous layer's output added in); the final norm is a
    ``rmsnorm_matmul`` with an untied head, else a ``residual_rmsnorm``.
    An encoder-decoder's decoder layer adds its ``norm_x`` (a
    ``residual_rmsnorm``); with ``encoder`` (a forward with
    ``encoder_tokens``) each encoder layer adds one of each, and its final
    ``enc_norm`` one ``residual_rmsnorm``."""
    L, tied = cfg.n_layers, int(cfg.tie_embeddings)
    if tuple(cfg.block_pattern) == ("rwkv6",):
        return {"rmsnorm": 2 * L + 1}
    fused = 0 if cfg.block_pattern[0] == "rwkv6" else cfg.n_superblocks
    n = {"rmsnorm_matmul": fused + 1 - tied,
         "residual_rmsnorm": 2 * L - fused + tied}
    if cfg.n_encoder_layers:
        n["residual_rmsnorm"] += cfg.n_layers
        if encoder:
            n["rmsnorm_matmul"] += cfg.n_encoder_layers
            n["residual_rmsnorm"] += cfg.n_encoder_layers + 1
    return n


def attention_launches(cfg: ModelConfig) -> int:
    """The decoder's attention-kernel launches per forward: one a
    self-attention or ``xattn`` layer, two an encoder-decoder's decoder
    layer (its self- and its cross-attention)."""
    n = sum(layer_kind(cfg, i) not in RECURRENT_KINDS
            for i in range(cfg.n_layers))
    return n + (cfg.n_layers if cfg.n_encoder_layers else 0)


def _attention_context(cfg, cache, b, s, dev, cache_index, lengths,
                       block_tables, positions):
    """The attention layers' shared context (positions, rope tables, the
    write and read indices), or None for a stack without attention."""
    first = next((i for i in range(cfg.n_layers)
                  if layer_kind(cfg, i) in ATTENTION_KINDS), None)
    paged = cache is not None and first is not None \
        and "k_pages" in cache[first]
    if paged != (block_tables is not None):
        raise ValueError("a paged cache needs block_tables=, and "
                         "block_tables= needs a paged cache")
    if first is None:
        return None
    if paged:
        n_pages, bs = cache[first]["k_pages"].shape[:2]
        return attn.paged_attention_context(
            cfg, b, s, dev, block_tables=block_tables, n_pages=n_pages,
            block_size=bs, cache_index=cache_index, lengths=lengths,
            positions=positions)
    max_len = cache[first]["k"].shape[1] if cache is not None else None
    return attn.attention_context(cfg, b, s, dev, cache_index=cache_index,
                                  lengths=lengths, positions=positions,
                                  max_len=max_len)


def _cross_cache(state: Optional[dict]) -> Optional[dict]:
    """A layer's cross cache as {"k","v"}, or None without a cache."""
    if state is None:
        return None
    return {"k": state["cross_k"], "v": state["cross_v"]}


def encode(params, frames, cfg: ModelConfig, *,
           remat_policy: Optional[str] = None) -> torch.Tensor:
    """The encoder over frame embeddings (B,T,D): non-causal layers over
    positions 0..T-1 with RoPE, then ``enc_norm``; returns (B,T,D) in the
    compute dtype, the cross-attention's source.  ``remat_policy``: each
    layer under ``remat_wrap`` (None: no recompute)."""
    ecfg = encoder_config(cfg)
    eps = cfg.norm_eps
    x = frames.to(cfg.cdtype)
    b, s = x.shape[0], x.shape[1]
    ctx = attn.attention_context(ecfg, b, s, x.device)
    m = None
    for i, bp in enumerate(params["enc_blocks"]):
        def layer(x, m, bp=bp):
            if m is not None:
                with scope("resid"):
                    x = x + m
            with scope("norm1"):
                y, h = kernels.rmsnorm_matmul(x, bp["norm1"]["scale"],
                                              bp["mixer"]["wq"], eps=eps)
            with scope("attn"):
                o = attn.attention_fwd(bp["mixer"], h, y, ecfg, ctx,
                                       causal=False)
            with scope("norm2"):
                h, x = kernels.residual_rmsnorm(x, bp["norm2"]["scale"],
                                                residual=o, eps=eps)
            with scope("mlp"):
                return x, mlp_fwd(bp["mlp"], h, ecfg)
        with scope(f"layer{i}"):
            x, m = remat_wrap(layer, remat_policy)(x, m)
    # the last layer's residual add fuses with enc_norm, as in the
    # reference's plan (no operator scope there either)
    out, _ = kernels.residual_rmsnorm(x, params["enc_norm"]["scale"],
                                      residual=m, eps=eps)
    return out


def forward(params, tokens, cfg: ModelConfig, *, cache: Optional[list] = None,
            cache_index: int = 0, lengths=None, block_tables=None,
            positions=None, encoder_tokens=None, frontend_embeds=None,
            reduce=None, with_aux: bool = False, return_hidden: bool = False,
            remat: bool = False, remat_policy: str = "nothing", dist=None,
            tp=None):
    """Returns (logits f32 (B,S,V), cache), or (out, cache, aux) with
    ``with_aux``.

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
    A Mamba or RWKV-6 layer runs every row's tokens through its state
    (free slots step too, as in the reference); positions select nothing
    there.  A MoE layer routes the B*S tokens of the call together: its
    capacity, and so its drops, depend on all of them.
    With ``tokens``, ``lengths`` and ``block_tables`` on the device the
    forward derives every index there and issues the same kernels for any
    values (``inference.backends.local`` captures it as a CUDA graph).
    ``encoder_tokens``: an encoder-decoder's frame embeddings (B,T,D), run
    through the encoder; ``frontend_embeds``: a vision stack's patch
    embeddings (B,T,D), the cross-attention's source as they are.  Either
    one sets every cross layer's K/V (written into the cache's cross
    entries, which must hold T positions: ``make_cache(src_len=T)``);
    without them a cross layer reads its K/V from the cache, as decode
    steps, verifies and the served prefill do, and a forward without
    either raises.
    ``reduce``: the tensor-parallel output hook ``(name, x) -> x``, applied
    to every attention layer's and every dense MLP's partial output
    (``attention_fwd``, ``mlp_fwd``); ``cfg`` then carries one rank's local
    head counts and ``params`` its shard (``inference.backends.sharded``,
    which serves pure-attention decoders only).  None: identity.

    The training options (``loss_fn``; a forward without cache):
    ``with_aux`` also returns the MoE load-balancing aux
    loss summed over the MoE layers (an f32 scalar, 0 without MoE), as the
    reference's forward does; ``return_hidden`` returns the final-normed
    hidden states (B,S,D) instead of the logits (an untied head's final
    norm is then a ``residual_rmsnorm``, its product left to the caller);
    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``), saving what ``remat_policy`` names
    (``REMAT_POLICIES``).

    ``dist``: a ``layers.moe.MeshContext`` inside a rank
    (``distributed.ranks``), passed to every MoE layer, which then runs
    expert parallel (``moe_ep_fwd``); ``tokens`` are the rank's block of
    the batch over ``dist.dp_axes``, ``params`` hold the rank's slice of
    the experts and everything else whole, and every other layer runs on
    the rank as it would alone, the same on every rank of a model group.
    None: the local MoE path.
    ``tp``: the rank's tensor-parallel plan (see the module's docstring);
    the logits are then the rank's vocabulary block.
    """
    check_supported(cfg)
    if with_aux or return_hidden or remat:
        check_trainable(cfg)
        if cache is not None:
            raise ValueError("with_aux / return_hidden / remat are for a "
                             "forward without cache (training)")
    embed = params["embed"]
    dev = embed.device
    tokens = torch.as_tensor(tokens).to(dev)
    b, s = tokens.shape
    if lengths is not None and cache is None:
        raise ValueError("lengths= (decode) needs a cache")
    if lengths is not None and s > 1:
        check_speculative(cfg)
    if is_recurrent(cfg) and block_tables is not None:
        raise ValueError(f"{cfg.name}: a recurrent stack has no paged "
                         "cache (block_tables=)")
    if tuple(cfg.block_pattern) == ("rwkv6",):
        out = _forward_rwkv(params, tokens, cfg, cache, tp=tp,
                            return_hidden=return_hidden,
                            remat_policy=remat_policy if remat else None)
        if with_aux:                            # no MoE: the aux loss is 0
            return out, cache, torch.zeros((), dtype=torch.float32,
                                           device=out.device)
        return out, cache
    ctx = _attention_context(cfg, cache, b, s, dev, cache_index, lengths,
                             block_tables, positions)
    decode = ctx is not None and ctx.decode
    encoder_out = None
    if cfg.n_encoder_layers and encoder_tokens is not None:
        # inside a rank the encoder runs whole, on the global head counts
        encoder_out = encode(params, torch.as_tensor(encoder_tokens).to(dev),
                             cfg if tp is None else tp.plan.cfg,
                             remat_policy=remat_policy if remat else None)
    elif frontend_embeds is not None:
        encoder_out = torch.as_tensor(frontend_embeds).to(dev, cfg.cdtype)
    with scope("embed"):
        x = (embed_tokens(embed, tokens, cfg) if tp is None
             else tp.embed(embed, tokens, cfg)).to(cfg.cdtype)
    aux = torch.zeros((), dtype=torch.float32, device=dev) if with_aux \
        else None
    seq = tp is not None and tp.seq_shard
    if seq:
        x = tp.seq_scatter(x)
    pending = None      # the previous layer's MLP output, not yet added
    period = len(cfg.block_pattern)
    for i, bp in enumerate(params["blocks"]):
        mixer, mlp = _layer_parts(
            bp, i, cfg, ctx, None if cache is None else cache[i],
            encoder_out, decode, reduce, with_aux, dist, tp)
        if seq and pending is None:
            # the superblock's stream arrives as the rank's block of S
            mixer = _seq_entry(mixer, tp)
        if seq and i % period == period - 1:
            mlp = _seq_exit(mlp, tp)
        with scope(f"layer{i}"):
            if remat and remat_policy == "names":
                # save each sub-block's output, recompute inside it
                x, o = remat_wrap(mixer, "names")(x, pending)
                x, pending, a = remat_wrap(mlp, "names")(x, o)
            else:
                # bound now: a checkpoint runs it again in the backward
                layer = functools.partial(_whole_layer, mixer, mlp)
                x, pending, a = remat_wrap(
                    layer, remat_policy if remat else None)(x, pending)
        if a is not None:
            aux = aux + a
    if seq:
        x = tp.seq_gather(x)
    eps = cfg.norm_eps
    if return_hidden:
        with scope("final_norm"):
            x, _ = kernels.residual_rmsnorm(
                x, params["final_norm"]["scale"], eps=eps)
        return (x, cache, aux) if with_aux else (x, cache)
    if not cfg.tie_embeddings:
        # an untied head fuses with the final norm (d x V), as in the
        # reference's plan; a tied one is read transposed, so no window
        enter = _entry(tp, "head")
        with scope("final_norm"), scope("unembed"):
            logits, _ = kernels.rmsnorm_matmul(
                enter(x), enter(params["final_norm"]["scale"]),
                params["lm_head"], eps=eps)
        logits = softcap(logits.float(), cfg.final_softcap)
    else:
        with scope("final_norm"):
            x, _ = kernels.residual_rmsnorm(x, params["final_norm"]["scale"],
                                            eps=eps)
        with scope("unembed"):
            logits = (unembed(x, embed, None, cfg) if tp is None
                      else tp.logits(x, params, cfg))
    return (logits, cache, aux) if with_aux else (logits, cache)


def _identity(t):
    return t


def _entry(tp, kind: str):
    """The entry of a region of kind ``kind``: ``tp.enter`` when the
    region's output is the rank's partial sum, else the identity."""
    return tp.enter if tp is not None and tp.partial(kind) else _identity


def _seq_entry(mixer, tp):
    """``mixer`` taking the residual stream as the rank's block of S: it
    is gathered whole first."""
    def run(x, pending):
        return mixer(tp.seq_gather(x), pending)
    return run


def _seq_exit(mlp, tp):
    """``mlp`` at a superblock's end, leaving the rank's block of S."""
    def run(x, o):
        x, pending, a = mlp(x, o)
        return tp.seq_scatter(x), pending, a
    return run


def pipeline_stages(params, n_stages: int) -> list:
    """The layer stack in ``n_stages`` contiguous stages of equal depth,
    each ``(first, blocks)``: the index of its first layer and its
    blocks.  One is a rank's ``stage_params`` for
    ``distributed.pipeline`` with ``stage_forward`` as the ``stage_fn``;
    the stage carries its offset, since a layer's kind, window and MoE
    slot follow its index in the whole stack."""
    blocks = params["blocks"]
    if n_stages < 1 or len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} layers do not split into "
                         f"{n_stages} stages of equal depth")
    per = len(blocks) // n_stages
    return [(s * per, blocks[s * per:(s + 1) * per])
            for s in range(n_stages)]


def stage_forward(stage, x, cfg: ModelConfig):
    """A pipeline stage ``(first, blocks)`` (``pipeline_stages``) on the
    residual stream x: ``forward_blocks`` from layer ``first``."""
    first, blocks = stage
    return forward_blocks(blocks, x, cfg, first=first)


def forward_blocks(blocks, x, cfg: ModelConfig, first: int = 0):
    """Layers ``first`` .. ``first + len(blocks) - 1`` on the residual
    stream x (B,S,D), without a cache and without the embedding or the
    final norm (a pipeline stage's body, ``stage_forward``).  The last
    layer's pending MLP output is added before returning, so that a stage
    ends on the whole residual."""
    check_supported(cfg)
    b, s, _ = x.shape
    ctx = _attention_context(cfg, None, b, s, x.device, 0, None, None, None)
    pending = None
    for j, bp in enumerate(blocks):
        mixer, mlp = _layer_parts(bp, first + j, cfg, ctx, None, None, False,
                                  None, False)
        with scope(f"layer{first + j}"):
            x, pending, _ = _whole_layer(mixer, mlp, x, pending)
    return x if pending is None else x + pending


def _whole_layer(mixer, mlp, x, pending):
    return mlp(*mixer(x, pending))


def _layer_parts(bp, i, cfg: ModelConfig, ctx, state, encoder_out, decode,
                 reduce, with_aux, dist=None, tp=None):
    """Layer i as two functions of the residual stream: ``mixer(x,
    pending) -> (x, o)`` (norm1, fusing the previous layer's pending MLP
    output into the residual or, at a superblock's first slot, the mixer's
    input product; the mixer; an encoder-decoder layer's cross-attention)
    and ``mlp(x, o) -> (x, pending, aux)`` (norm2 fusing the mixer's
    output, the MLP, MoE or RWKV-6 channel mix, and at a superblock's last
    slot the residual add; ``pending`` is the MLP output left for the next
    layer's norm1, ``aux`` the MoE aux loss or None).  An RWKV-6 slot's
    token shift comes before its first product, so at a superblock's first
    slot its norm1 is a ``residual_rmsnorm`` without a residual, as the
    reference's plan lowers its bare ``rmsnorm`` window."""
    kind = layer_kind(cfg, i)
    eps = cfg.norm_eps
    period = len(cfg.block_pattern)
    w_in = (None if kind == "rwkv6" else
            bp["mixer"]["in_proj"] if kind == "mamba" else bp["mixer"]["wq"])
    enter = _entry(tp, kind)
    red = tp.reduce if enter is not _identity else reduce
    akw = {} if tp is None else {"kv_sel": tp.kv_sel}
    wkv = None if tp is None else tp.wkv
    xkw = {} if tp is None else {"seq_split": tp.cross_split}
    xenter = _entry(tp, "xattn")
    cross_kv = encoder_out if encoder_out is None else xenter(encoder_out)

    def mixer(x, pending):
        # a superblock's first norm1 fuses with the mixer's input
        # product; a later slot's fuses the residual add before it
        with scope("norm1"):
            if pending is None and w_in is not None:
                y, h = kernels.rmsnorm_matmul(
                    enter(x), enter(bp["norm1"]["scale"]), w_in, eps=eps)
            else:
                h, x = kernels.residual_rmsnorm(
                    x, bp["norm1"]["scale"], residual=pending, eps=eps)
                h, y = enter(h), None
        with scope(MIXER_SCOPE[kind]):
            if kind == "mamba":
                o, _ = mamba.mamba_fwd(bp["mixer"], h, cfg, state=state,
                                       xz=y, reduce=red)
            elif kind == "rwkv6":
                o = rwkv.rwkv_time_fwd(bp["mixer"], h, cfg, state,
                                       reduce=red, wkv=wkv)
            elif kind == "xattn":
                o = attn.cross_attention_fwd(
                    bp["mixer"], h, y, cfg, cache=_cross_cache(state),
                    cross_kv=cross_kv, decode=decode, reduce=red, **akw,
                    **xkw)
                o = o * torch.tanh(bp["xgate"]).to(o.dtype)
            else:
                o = attn.attention_fwd(
                    bp["mixer"], h, y, cfg, ctx, cache=state,
                    window=layer_window(cfg, i), reduce=red,
                    seq_split=None if tp is None else tp.seq_split, **akw)
        if "xattn" in bp:
            # enc-dec: cross-attention after the self-attention, its
            # norm fusing the residual add before it
            with scope("xattn"):
                with scope("norm_x"):
                    h, x = kernels.residual_rmsnorm(
                        x, bp["norm_x"]["scale"], residual=o, eps=eps)
                o = attn.cross_attention_fwd(
                    bp["xattn"], xenter(h), None, cfg,
                    cache=_cross_cache(state), cross_kv=cross_kv,
                    decode=decode,
                    reduce=tp.reduce if xenter is not _identity else reduce,
                    **akw, **xkw)
        return x, o

    mlp_enter = _entry(tp, "moe" if "moe" in bp else "mlp")
    mlp_red = tp.reduce if mlp_enter is not _identity else reduce

    def mlp(x, o):
        with scope("norm2"):
            h, x = kernels.residual_rmsnorm(x, bp["norm2"]["scale"],
                                            residual=o, eps=eps)
        h = mlp_enter(h)
        a = None
        if "moe" in bp:
            with scope("moe"):
                m, a = moe.moe_fwd(bp["moe"], h, cfg, dist=dist,
                                   with_aux=with_aux)
        elif kind == "rwkv6":
            with scope("rwkv_channel"):
                m = rwkv.rwkv_channel_fwd(bp["mlp"], h, cfg, state,
                                          reduce=mlp_red)
        else:
            with scope("mlp"):
                m = mlp_fwd(bp["mlp"], h, cfg, reduce=mlp_red)
        if i % period == period - 1:
            with scope("resid"):
                return x + m, None, a
        return x, m, a

    return mixer, mlp


def _forward_rwkv(params, tokens, cfg: ModelConfig, cache, tp=None,
                  return_hidden: bool = False, remat_policy=None):
    """RWKV-6 logits (B,S,V) f32 (the final-normed hidden states with
    ``return_hidden``).  Every row runs the
    recurrence from its cache state; there are no positions, so
    ``cache_index`` and ``lengths`` have nothing to select (free slots
    step too, as in the reference).  The norms fuse each residual add into
    the next norm.  ``remat_policy``: each layer under ``remat_wrap``."""
    eps = cfg.norm_eps
    with scope("embed"):
        x = (embed_tokens(params["embed"], tokens, cfg) if tp is None
             else tp.embed(params["embed"], tokens, cfg)).to(cfg.cdtype)
    enter_t, enter_c = _entry(tp, "rwkv6"), _entry(tp, "mlp")
    red_t = tp.reduce if enter_t is not _identity else None
    red_c = tp.reduce if enter_c is not _identity else None
    wkv = None if tp is None else tp.wkv
    res = None
    for i, bp in enumerate(params["blocks"]):
        state = None if cache is None else cache[i]

        def layer(x, res, bp=bp, state=state):
            with scope("norm1"):
                h, x = kernels.rmsnorm(x, bp["norm1"]["scale"], residual=res,
                                       eps=eps)
            with scope("rwkv"):
                o = rwkv.rwkv_time_fwd(bp["mixer"], enter_t(h), cfg, state,
                                       reduce=red_t, wkv=wkv)
            with scope("norm2"):
                h, x = kernels.rmsnorm(x, bp["norm2"]["scale"], residual=o,
                                       eps=eps)
            with scope("rwkv_channel"):
                return x, rwkv.rwkv_channel_fwd(bp["mlp"], enter_c(h), cfg,
                                                state, reduce=red_c)
        with scope(f"layer{i}"):
            x, res = remat_wrap(layer, remat_policy)(x, res)
    with scope("final_norm"):
        x, _ = kernels.rmsnorm(x, params["final_norm"]["scale"],
                               residual=res, eps=eps)
    if return_hidden:
        return x
    with scope("unembed"):
        if tp is not None:
            return tp.logits(x, params, cfg)
        return unembed(x, params["embed"], params.get("lm_head"), cfg)


# =========================================================== training
# The reference's REMAT_POLICIES, as the ops whose outputs a layer's
# checkpoint keeps (torch.utils.checkpoint's selective checkpointing):
# "nothing" recomputes all; "dots" keeps every product, the batched ones
# (attention, the experts' bmm) too; "dots_no_batch" keeps only the
# products without batch dims; "names" keeps each sub-block's output (the
# mixer's and the MLP's: the forward checkpoints the two separately).
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "names")


def _saved_ops(policy: str) -> list:
    aten, ops = torch.ops.aten, torch.ops.repro_torch
    unbatched = [aten.mm.default, aten.addmm.default,
                 ops.rmsnorm_matmul.default]
    if policy == "dots":
        return unbatched + [aten.bmm.default, aten.baddbmm.default,
                            ops.flash_attention.default]
    return unbatched if policy == "dots_no_batch" else []


def remat_wrap(fn, policy: Optional[str]):
    """``fn`` recomputed in the backward under ``policy`` (one of
    ``REMAT_POLICIES``; "names" checkpoints ``fn`` whole), or ``fn`` as it
    is for None."""
    if policy is None:
        return fn
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; have "
                         f"{REMAT_POLICIES}")
    kw, saved = {}, _saved_ops(policy)
    if saved:
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, saved)
    return functools.partial(torch_checkpoint.checkpoint, fn,
                             use_reentrant=False, **kw)


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a stack the port cannot train: one it does not run at
    all (``check_supported``).  Every kernel on a training path has a
    backward rule, ``wkv6``'s through its functional entry."""
    check_supported(cfg)


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True,
            remat_policy: str = "nothing", aux_weight: float = 0.01,
            loss_chunks: int = 1, dist=None, tp=None):
    """Next-token CE plus ``aux_weight`` times the MoE aux loss; returns
    (loss, (ce, aux)), f32 scalars.  ``batch``: {"tokens", "labels"} (B,S)
    and, for the cross stacks, "encoder_tokens" or "frontend_embeds"
    (B,T,D), tensors or numpy arrays (``data.make_batch``).
    ``loss_chunks`` > 1 takes the CE over that many sequence chunks, each
    chunk's unembed recomputed in the backward (``_chunked_ce``), so the
    (B,S,V) logits never exist at once.  With ``dist`` (inside a rank, see
    ``forward``) the CE is the mean over the rank's own tokens and the aux
    the MoE layers' per-shard mean, the same on every rank: the global
    loss is the mean of the data-parallel ranks' losses.  With ``tp`` (a
    rank's tensor-parallel plan) the logits are the rank's vocabulary
    block and the CE is vocabulary-parallel (``tp.ce_sum``)."""
    check_trainable(cfg)
    dev = params["embed"].device
    labels = torch.as_tensor(batch["labels"]).to(dev).long()
    kw = dict(encoder_tokens=batch.get("encoder_tokens"),
              frontend_embeds=batch.get("frontend_embeds"), remat=remat,
              remat_policy=remat_policy, with_aux=True, dist=dist, tp=tp)
    if loss_chunks > 1:
        hidden, _, aux = forward(params, batch["tokens"], cfg,
                                 return_hidden=True, **kw)
        ce = _chunked_ce(hidden, labels, params, cfg, loss_chunks, tp)
    else:
        logits, _, aux = forward(params, batch["tokens"], cfg, **kw)
        ce = (_ce_sum if tp is None else tp.ce_sum)(logits, labels) \
            / labels.numel()
    return ce + aux_weight * aux, (ce, aux)


def _ce_sum(logits, labels) -> torch.Tensor:
    """Sum over tokens of logsumexp(logits) - logits[label], in f32."""
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def _chunked_ce(hidden, labels, params, cfg: ModelConfig, n_chunks: int,
                tp=None):
    """Mean CE over ``n_chunks`` sequence chunks of the final hidden states
    (B,S,D); each chunk's logits are made by the unembed inside a
    checkpoint and made again in the backward."""
    b, s, _ = hidden.shape
    if s % n_chunks:
        raise ValueError(f"sequence {s} not divisible into {n_chunks} "
                         "loss chunks")
    sc = s // n_chunks

    def chunk(xc, lc):
        if tp is not None:
            return tp.ce_sum(tp.logits(xc, params, cfg), lc)
        logits = unembed(xc, params["embed"], params.get("lm_head"), cfg)
        return _ce_sum(logits, lc)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        part = slice(c * sc, (c + 1) * sc)
        total = total + torch_checkpoint.checkpoint(
            chunk, hidden[:, part], labels[:, part], use_reentrant=False)
    return total / (b * s)


def param_count(params) -> int:
    return sum(leaf.numel() for leaf in leaves(params))


def active_param_count(params, cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k of n_experts), excl.
    embeddings, by the reference's key rules."""
    total = 0
    for key, leaf in named_leaves(params):
        keys = key.split("/")
        if "embed" in keys or "lm_head" in keys:
            continue
        n = leaf.numel()
        if cfg.moe and "moe" in keys and \
                any(k in ("w_in", "w_gate", "w_out") for k in keys):
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total
