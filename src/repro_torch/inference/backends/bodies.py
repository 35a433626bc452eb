"""The serving step bodies of the contiguous and the paged cache.

Counterpart of ``repro/inference/backends/bodies.py`` (prefill, decode,
paged prefill chunk and paged decode; the verify bodies come with
speculative decoding, ROADMAP Queue A "speculative decoding").  One
source of numerics for every backend and plan: anything that changes
logits or cache writes belongs here.

Each body takes its per-step inputs (tokens, lengths, block tables, the
prefill's slot) as device tensors of fixed shape and its shape-setting
arguments (``plen``, the chunk's ``t0``) as Python ints, and picks nothing
by value on the host, so ``LocalBackend`` can capture it as a CUDA graph
and replay it for any input values.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, is_recurrent


class StepBodies(NamedTuple):
    """Step functions: (params, cache, ...) -> (logits rows, cache)."""
    prefill: Callable          # contiguous prefill of one slot
    decode: Callable           # batched contiguous decode step
    paged_prefill: Callable    # one paged prefill chunk
    paged_decode: Callable     # batched paged decode step
    # bodies whose second run on the same inputs differs from the first
    # (the recurrent state advances twice); every other body rewrites the
    # same cache entries with the same values
    advance_state: tuple = ()


_ALIGN = 16     # bytes: each leaf's row starts aligned for vector loads


def _zeroed_row(cache) -> list:
    """A zeroed (1, ...) row of every cache leaf, laid out as the leaf's
    own slot row, carved from one buffer per dtype: one fill kernel per
    dtype rather than one per leaf, as many as zeroing the slot's rows in
    place would take."""
    dev = next(iter(cache[0].values())).device
    sizes: dict = {}
    for c in cache:
        for t in c.values():
            unit = max(1, _ALIGN // t.element_size())
            n = t.numel() // t.shape[0]
            sizes.setdefault(t.dtype, []).append(-(-n // unit) * unit)
    parts = {dt: iter(torch.zeros(sum(n), dtype=dt, device=dev).split(n))
             for dt, n in sizes.items()}
    return [{name: next(parts[t.dtype])[:t.numel() // t.shape[0]]
             .view(1, *t.shape[1:]) for name, t in c.items()}
            for c in cache]


def make_step_bodies(cfg: ModelConfig) -> StepBodies:
    def prefill_body(params, cache, tokens, slot, plen: int):
        # tokens: (1, bucket) padded, or exactly the plen prompt tokens for
        # a recurrent stack or an encoder (engine.py); slot: (1,) device
        # index.  The prompt is written into a zeroed one-row cache, as the
        # reference zeroes the slot's rows first, so nothing of a previous
        # occupant (KV or recurrent state) survives; that row then replaces
        # the slot's by a device index.
        row = _zeroed_row(cache)
        logits, _ = forward(params, tokens, cfg, cache=row, cache_index=0)
        index = slot.long()
        for c, r in zip(cache, row):
            for name, t in c.items():
                t.index_copy_(0, index, r[name])
        return logits[:, plen - 1], cache

    def decode_body(params, cache, tokens, lengths):
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                lengths=lengths)
        return logits[:, 0], cache

    def paged_prefill_body(params, cache, tokens, bt_row, t0: int):
        # tokens: (1, C) one chunk; bt_row: (1, NB) the slot's block table;
        # t0: the chunk's start offset
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                cache_index=t0, block_tables=bt_row)
        return logits[:, -1], cache

    def paged_decode_body(params, cache, tokens, lengths, block_tables):
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                lengths=lengths, block_tables=block_tables)
        return logits[:, 0], cache

    return StepBodies(prefill_body, decode_body, paged_prefill_body,
                      paged_decode_body,
                      advance_state=("decode",) if is_recurrent(cfg) else ())
