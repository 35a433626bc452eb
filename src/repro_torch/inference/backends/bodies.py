"""The serving step bodies of the contiguous and the paged cache.

Counterpart of ``repro/inference/backends/bodies.py`` (prefill, decode,
paged prefill chunk, paged decode and the two speculative verifies) and of
the draft step of ``repro/inference/backends/speculative.py``.  One
source of numerics for every backend and plan: anything that changes
logits or cache writes belongs here.

Each body takes its per-step inputs (tokens, lengths, block tables, the
prefill's slot and prompt length) as device tensors of fixed shape and its
shape-setting argument (the chunk's ``t0``) as a Python int, and picks
nothing by value on the host, so ``LocalBackend`` can capture it as a CUDA
graph and replay it for any input values.  The prompt length is a device
input (the reference keeps it static, one compile per length): one capture
or trace then serves every prompt of a bucket.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward as _forward
from repro_torch.models import is_recurrent


class StepBodies(NamedTuple):
    """Step functions: (params, cache, ...) -> (logits rows, cache)."""
    prefill: Callable          # contiguous prefill of one slot
    decode: Callable           # batched contiguous decode step
    paged_prefill: Callable    # one paged prefill chunk
    paged_decode: Callable     # batched paged decode step
    verify: Callable           # k+1 tokens a row, every logits row back
    paged_verify: Callable     # the same over the paged pool
    draft_step: Callable       # explicit positions, the last logits row
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


def make_step_bodies(cfg: ModelConfig, reduce=None) -> StepBodies:
    """The step bodies of ``cfg``; ``reduce``: the tensor-parallel output
    hook forwarded to every ``forward`` (``backends.sharded`` passes the
    rank's local config and its all-reduce; None: one device)."""
    def forward(*args, **kw):
        return _forward(*args, reduce=reduce, **kw)

    def prefill_body(params, cache, tokens, slot, plen):
        # tokens: (1, bucket) padded, or exactly the plen prompt tokens for
        # a recurrent stack or an encoder (engine.py); slot, plen: (1,)
        # device ints.  The prompt is written into a zeroed one-row cache,
        # as the reference zeroes the slot's rows first, so nothing of a
        # previous occupant (KV or recurrent state) survives; that row then
        # replaces the slot's by a device index.
        row = _zeroed_row(cache)
        logits, _ = forward(params, tokens, cfg, cache=row, cache_index=0)
        index = slot.long()
        for c, r in zip(cache, row):
            for name, t in c.items():
                t.index_copy_(0, index, r[name])
        return logits.index_select(1, plen.long() - 1)[:, 0], cache

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

    def verify_body(params, cache, tokens, lengths):
        # tokens (B, k+1): the last emitted token and the k draft tokens of
        # each row, written at lengths[b] + j; every row's logits back
        return forward(params, tokens, cfg, cache=cache, lengths=lengths)

    def paged_verify_body(params, cache, tokens, lengths, block_tables):
        return forward(params, tokens, cfg, cache=cache, lengths=lengths,
                       block_tables=block_tables)

    def draft_step_body(params, cache, tokens, positions, lengths):
        # right-aligned draft step with explicit per-row positions (B, W):
        # the catch-up after a fully accepted window feeds 2 tokens, later
        # steps 1; a padding column carries position max_len (its write
        # drops) and its logits are not read.  Only the last column's
        # logits matter: the next proposal.
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                positions=positions, lengths=lengths)
        return logits[:, -1], cache

    return StepBodies(prefill_body, decode_body, paged_prefill_body,
                      paged_decode_body, verify_body, paged_verify_body,
                      draft_step_body,
                      advance_state=("decode",) if is_recurrent(cfg) else ())
