"""Int8 gradient compression with error feedback, for the data-parallel
all-reduce.

Counterpart of ``repro/distributed/compression.py``.  Each leaf is
quantized per tensor to int8 against the absmax of the gradient plus its
carried error (scale = absmax / 127, round half to even, clipped to
+-127); every rank's int8 payloads and f32 scales are all-gathered over
the axis and the scale-weighted sum is taken locally in f32, over n, and
cast to the gradient's dtype; the quantization error, in f32, is fed into
the next step's gradients (error feedback keeps SGD-style convergence).

The reference's ``compressed_psum`` runs inside ``shard_map``; here it
runs inside a rank (``distributed.ranks``) and takes the rank's context
where the reference names the axis.  The wire carries one int8 a gradient
element and one f32 scale a leaf, never the f32 gradient: every leaf's
payload goes in one all-gather of a flat int8 buffer, the scales in one
of a flat f32 vector, so a step makes two exchanges whatever the number of
leaves (the reference gathers leaf by leaf; the values are the same).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import all_gather, pmean
from repro_torch.tree import leaves, map_tree


def _quantize(x: torch.Tensor, err: torch.Tensor):
    """(int8 payload, f32 scale, new f32 error) of ``x`` + ``err``."""
    xf = x.float() + err
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = xf - q.float() * scale
    return q, scale, new_err


def _unflatten(tree, values: list):
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


def compressed_psum(grads, errors, ctx, axis="data"):
    """Per-leaf int8 all-reduce over ``axis`` with error feedback, inside
    a rank.  Returns (mean gradients in each leaf's dtype, new f32 error
    state), trees shaped like ``grads``."""
    n = ctx.size(axis)
    gs, es = leaves(grads), leaves(errors)
    if len(gs) != len(es):
        raise ValueError(f"{len(gs)} gradient leaves, {len(es)} error "
                         "leaves")
    qs, scales, new_es = zip(*(_quantize(g, e) for g, e in zip(gs, es)))
    q_all = all_gather(torch.cat([q.reshape(-1) for q in qs]), ctx, axis)
    s_all = all_gather(torch.stack(scales), ctx, axis)          # (n, leaves)
    out, off = [], 0
    for i, g in enumerate(gs):
        q = q_all[:, off:off + g.numel()].float()                 # (n, size)
        off += g.numel()
        val = torch.tensordot(s_all[:, i], q, dims=([0], [0]))
        out.append((val / n).view(g.shape).to(g.dtype))
    return _unflatten(grads, out), _unflatten(grads, list(new_es))


def init_error_state(grads_like):
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def wire_bytes(grads, n: int) -> dict:
    """Bytes one rank sends and receives in one ``compressed_psum`` of
    ``grads`` over ``n`` ranks (its int8 payload and f32 scales to each of
    n - 1 peers, theirs back), beside an f32 ring all-reduce's (2 (n - 1)
    / n of the f32 gradient each way)."""
    ls = leaves(grads)
    elems = sum(g.numel() for g in ls)
    int8 = 2 * (n - 1) * (elems + 4 * len(ls))
    f32 = 2 * 2 * (n - 1) * 4 * elems // n
    return {"int8": int8, "f32_allreduce": f32}


def make_compressed_dp_grad(loss_fn, ctx, axis: str = "data"):
    """Explicit data parallelism inside a rank: the batch split over
    ``axis`` (each rank passes its own), the parameters replicated, the
    gradients meaned through the int8 ``compressed_psum``.
    ``loss_fn(params, local_batch) -> (loss, aux)``.

    Returns grad_step(params, errors, local_batch) -> (grads, new_errors,
    loss), the loss ``pmean``-ed over the axis.  The caller's tensors get
    no ``.grad``."""

    def grad_step(params, errors, local_batch):
        ps = map_tree(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, _ = loss_fn(ps, local_batch)
            ls = leaves(ps)
            gs = torch.autograd.grad(loss, ls, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(ls, gs)]
        grads, new_errors = compressed_psum(_unflatten(params, gs), errors,
                                            ctx, axis)
        return grads, new_errors, pmean(loss.detach(), ctx, axis)

    return grad_step
