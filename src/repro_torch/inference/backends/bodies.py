"""The serving step bodies of the contiguous and the paged cache.

Counterpart of ``repro/inference/backends/bodies.py`` (prefill, decode,
paged prefill chunk and paged decode; the verify bodies come with
speculative decoding, ROADMAP Queue A "speculative decoding").  One
source of numerics for every backend: anything that changes logits or
cache writes belongs here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward


class StepBodies(NamedTuple):
    """Step functions: (params, cache, ...) -> (logits rows, cache)."""
    prefill: Callable          # contiguous prefill of one slot
    decode: Callable           # batched contiguous decode step
    paged_prefill: Callable    # one paged prefill chunk
    paged_decode: Callable     # batched paged decode step


def make_step_bodies(cfg: ModelConfig) -> StepBodies:
    def prefill_body(params, cache, tokens, slot: int, plen: int):
        # tokens: (1, bucket) padded, or exactly the plen prompt tokens for
        # a recurrent stack (engine.py).  The slot's rows are ZEROED first,
        # as the reference does, so nothing of a previous occupant (KV or
        # recurrent state) survives; the forward then writes the prompt
        # into a one-row view of them.
        sub = [{name: t[slot:slot + 1] for name, t in c.items()}
               for c in cache]
        for c in sub:
            for t in c.values():
                t.zero_()
        logits, _ = forward(params, tokens, cfg, cache=sub, cache_index=0)
        return logits[:, plen - 1], cache

    def decode_body(params, cache, tokens, lengths):
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                lengths=lengths)
        return logits[:, 0], cache

    def paged_prefill_body(params, cache, tokens, bt_row, t0: int):
        # tokens: (1, C) one chunk; bt_row: (NB,) the slot's block table
        # (host array); t0: the chunk's start offset
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                cache_index=t0, block_tables=bt_row[None])
        return logits[:, -1], cache

    def paged_decode_body(params, cache, tokens, lengths, block_tables):
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                lengths=lengths, block_tables=block_tables)
        return logits[:, 0], cache

    return StepBodies(prefill_body, decode_body, paged_prefill_body,
                      paged_decode_body)
