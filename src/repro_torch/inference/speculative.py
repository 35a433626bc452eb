"""Speculative-decoding policy: greedy accept/reject + launch-tax-aware depth.

Copy of ``repro/inference/speculative.py``, over the port's parameter
layout.  The device-free half of speculation.  ``greedy_accept`` is the
scheduler's accept rule — longest draft prefix matching target argmax,
then the target's own correction token — which keeps emitted tokens
identical to plain greedy decoding no matter how good or bad the draft
is: every emitted token is an argmax the *target* computed from the true
prefix.

``pick_spec_k`` is the paper-facing part: speculation trades MORE kernel
launches (the draft's extra dispatch stream) for FEWER sequential target
steps, so it pays off exactly where decode is CPU/dispatch-bound — low
batch, and on coupled (CC) parts up to ~4x larger batches than LC parts.
The policy takes the measured/modeled CPU->GPU-bound inflection batch
(``telemetry.characterize`` / ``core.boundedness``) and goes deep below it,
shallow approaching it, off above it.

Draft construction: the default draft is the TARGET truncated to its first
``n`` superblocks ("layer-skip" self-speculation) — it shares the embedding,
final norm, and unembed, so the vocab matches by construction and the
proposals track the target distribution without any extra training.  The
port's layers are a list (``params["blocks"]``), so the draft's is the
list's first ``n_layers`` entries: the same tensors, no copy, no device
memory of its own.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig


# --------------------------------------------------------------- accept rule
def greedy_accept(draft_tokens: Sequence[int],
                  target_argmax: Sequence[int]) -> tuple[int, list]:
    """Longest-prefix accept against target argmax.

    ``draft_tokens``: the k proposed tokens.  ``target_argmax``: k+1 argmax
    rows from the batched verify — position j is the target's next token
    after the true prefix plus draft_tokens[:j].  Returns ``(n_accepted,
    emitted)`` where ``emitted`` is the accepted prefix plus the target's
    correction token (the argmax right after the last accepted draft token).
    Always emits >= 1 token, and every emitted token equals what sequential
    greedy decoding would produce.
    """
    if len(target_argmax) != len(draft_tokens) + 1:
        raise ValueError(
            f"verify must cover k+1 positions: got {len(draft_tokens)} "
            f"draft tokens but {len(target_argmax)} target rows")
    n = 0
    for d, t in zip(draft_tokens, target_argmax):
        if int(d) != int(t):
            break
        n += 1
    emitted = [int(t) for t in target_argmax[:n]] + [int(target_argmax[n])]
    return n, emitted


def accept_lengths(draft_tokens: np.ndarray,
                   target_argmax: np.ndarray) -> np.ndarray:
    """Vectorized ``greedy_accept`` prefix lengths: (B,k) x (B,k+1) -> (B,)."""
    match = draft_tokens == target_argmax[:, :-1]
    return np.where(match.all(axis=1), match.shape[1],
                    np.argmin(match, axis=1)).astype(np.int64)


# --------------------------------------------------------------- depth policy
def pick_spec_k(batch: int, *, max_k: int,
                inflection_batch: Optional[int] = None) -> int:
    """Launch-tax-aware speculation depth for one scheduler round.

    ``inflection_batch`` is the batch where decode flips from CPU/dispatch-
    bound to GPU/compute-bound (``BoundednessResult.inflection_batch``;
    None = CPU-bound over the whole measured range).  Deep where launches
    dominate (speculation amortizes the per-step launch tax over multiple
    emitted tokens), shallow approaching the inflection (the batched verify
    costs ~(k+1)x decode compute), off where the engine is compute-bound.
    """
    if max_k < 1 or batch < 1:
        return 0
    if inflection_batch is None or 2 * batch <= inflection_batch:
        return max_k                      # deep: launch tax dominates
    if batch < inflection_batch:
        return max(1, max_k // 2)         # shallow: nearing compute-bound
    return 0                              # off: GPU-bound, verify can't pay


# ---------------------------------------------------------- draft construction
def default_draft_config(cfg: ModelConfig) -> ModelConfig:
    """Truncated-target draft: half the superblocks, everything else shared."""
    n_sb = max(1, cfg.n_superblocks // 2)
    return cfg.replace(name=f"{cfg.name}-draft{n_sb}sb",
                       n_layers=n_sb * len(cfg.block_pattern))


def is_truncation_of(draft_cfg: ModelConfig, cfg: ModelConfig) -> bool:
    """True when draft params can be SLICED from the target's blocks
    (same per-layer geometry, fewer superblocks)."""
    return (draft_cfg.block_pattern == cfg.block_pattern
            and draft_cfg.d_model == cfg.d_model
            and draft_cfg.n_heads == cfg.n_heads
            and draft_cfg.n_kv_heads == cfg.n_kv_heads
            and draft_cfg.hd == cfg.hd
            and draft_cfg.d_ff == cfg.d_ff
            and draft_cfg.vocab_size == cfg.vocab_size
            and draft_cfg.n_superblocks <= cfg.n_superblocks)


def draft_params_from_target(params, draft_cfg: ModelConfig):
    """The target's first ``draft_cfg.n_superblocks * len(block_pattern)``
    layers; embedding, final norm and unembed are shared by reference (no
    tensor is copied)."""
    out = dict(params)
    out["blocks"] = params["blocks"][:draft_cfg.n_superblocks
                                     * len(draft_cfg.block_pattern)]
    return out


def validate_draft(cfg: ModelConfig, draft_cfg: ModelConfig,
                   spec_k: int) -> None:
    """Actionable CLI/engine validation for the speculative options."""
    if spec_k < 1:
        raise ValueError(
            f"spec_k must be >= 1, got {spec_k} (k draft tokens are "
            "proposed per round; use speculative=False to disable)")
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft config {draft_cfg.name!r} has vocab_size="
            f"{draft_cfg.vocab_size} but target {cfg.name!r} has "
            f"{cfg.vocab_size}: speculation verifies draft token ids "
            "against target argmax, so draft and target must share the "
            "tokenizer/vocab (pick a truncated/narrower variant of the "
            "same family)")
    if draft_cfg.n_layers >= cfg.n_layers and is_truncation_of(
            draft_cfg, cfg):
        raise ValueError(
            f"draft config {draft_cfg.name!r} ({draft_cfg.n_layers} "
            f"layers) is not smaller than the target ({cfg.n_layers} "
            "layers): a draft at least as deep as the target proposes at "
            "target cost and cannot win the launch trade")
