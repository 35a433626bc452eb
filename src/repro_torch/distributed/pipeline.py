"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe``
mesh axis.

Counterpart of ``repro/distributed/pipeline.py``.  The layer stack is
split into P stages, one a rank of the pipe axis (``distributed.ranks``);
each rank holds its own stage's parameters (the reference's stage-major
stacked leaf, its slice on that device).  ``n_micro + P - 1`` ticks drive
the classic diagram: stage 0 injects microbatch t at tick t (zeros once
drained), every stage applies ``stage_fn`` to what it holds, activations
hop stage -> stage + 1 through ``ppermute`` each tick, and the last stage
emits microbatch t at tick t + P - 1.  Bubble fraction = (P - 1) / ticks.
Every rank returns the last stage's (n_micro, mb, ...) outputs, which the
reference's ``shard_map`` gives as its global result (here a broadcast
from the last stage).

A model's stages are ``models.pipeline_stages``' ``(first, blocks)``
with ``models.stage_forward`` as ``stage_fn``: each stage runs its layers
under their indices in the whole stack.

The schedule is a forward: ``ppermute`` carries no gradient, as no caller
of the reference differentiates it.  ``reference_forward`` is the
sequential oracle.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.collectives import broadcast, ppermute


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_forward(stage_fn: Callable, stage_params, x_micro, ctx,
                     axis: str = "pipe"):
    """Run this rank's stage of a P-stage pipeline over microbatches.

    stage_fn: (params_for_one_stage, x) -> y       (same shape)
    stage_params: this rank's stage's parameters
    x_micro: (n_micro, mb, ...) microbatched input (every rank's the same)
    Returns (n_micro, mb, ...) outputs of the last stage, on every rank.
    """
    n_stages, stage = ctx.size(axis), ctx.index(axis)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    zero = torch.zeros_like(x_micro[0])
    buf, ys = zero, []
    for t in range(ticks):
        inject = x_micro[t] if t < n_micro else zero
        y = stage_fn(stage_params, inject if stage == 0 else buf)
        # shift activations one stage down the line
        buf = ppermute(y, ctx, axis)
        if t >= n_stages - 1:
            ys.append(y)
    # the last stage's ys are the outputs; the others' only give the shape
    return broadcast(torch.stack(ys), ctx, axis, n_stages - 1)


def reference_forward(stage_fn: Callable, stage_params: list, x_micro):
    """Sequential oracle: all stages (``stage_params``, one tree a stage)
    applied to each microbatch in order."""
    outs = []
    for x in x_micro:
        for p in stage_params:
            x = stage_fn(p, x)
        outs.append(x)
    return torch.stack(outs)
