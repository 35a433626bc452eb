"""The serving step bodies of the contiguous cache.

Counterpart of ``repro/inference/backends/bodies.py`` (prefill and decode;
the paged and verify bodies come with their slices).  One source of
numerics for every backend: anything that changes logits or cache writes
belongs here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward


class StepBodies(NamedTuple):
    """Step functions: (params, cache, ...) -> (logits rows, cache)."""
    prefill: Callable          # contiguous prefill of one slot
    decode: Callable           # batched contiguous decode step


def make_step_bodies(cfg: ModelConfig) -> StepBodies:
    def prefill_body(params, cache, tokens, slot: int, plen: int):
        # tokens: (1, bucket) padded.  The slot's rows are ZEROED first, as
        # the reference does, so nothing of a previous occupant survives;
        # the forward then writes the prompt into a one-row view of them.
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

    return StepBodies(prefill_body, decode_body)
