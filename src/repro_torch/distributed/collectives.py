"""The collectives a rank's body calls: the port's copy of what
``jax.lax`` (and ``repro/distributed/compat.py``'s ``axis_size``) gives a
``shard_map`` body.

Each takes the rank's context (``distributed.ranks.RankContext``) and the
mesh axes it runs over, a name or a tuple of names, and uses the rank's
gloo group over those axes; over axes of size 1 it is the identity.  The
context's ``size(axes)`` and ``index(axes)`` are ``axis_size`` and
``jax.lax.axis_index``.  For a
CUDA tensor every exchange stages through a pinned host buffer
(``ranks.to_host``, as the tensor-parallel backend's all-reduces do:
device to host, the gloo exchange, host to device): transport only, all
compute stays on the card.  A sum of bf16 or f16 is taken in f32.  Every exchange
is counted in the rank's ``ctx.wire`` (``ranks.WireStats``).

Gradients.  ``psum``, ``pmean``, a tiled ``all_gather`` and ``all_to_all``
are ``torch.autograd.Function`` s whose backward is the transpose under
the port's convention for a rank's gradients:

* over a data-parallel axis (``pod``, ``data``) the ranks hold different
  examples; the global loss is the mean of the ranks' losses, and a rank's
  backward gives the gradient of the SUM of every rank's loss with respect
  to its own tensors.  So a leaf replicated over the axis is meaned over
  it afterwards (``make_compressed_dp_grad`` does), and the gradient of a
  leaf split over it (ZeRO-3 storage, gathered with ``all_gather``) is the
  mean reduce-scatter of the gathered leaf's;
* over any other axis (``model``, ``pipe``) every rank computes the same
  loss from replicated activations, and its cotangent of a replicated
  tensor is already the whole one: it is never summed over the axis.

So ``psum``'s and ``pmean``'s backward sum the cotangent over the data
axes only (``pmean``'s then divides by the group's size); a tiled
``all_gather``'s takes the rank's own slice of that sum (divided by the
data axes' size); ``all_to_all``'s is ``all_to_all`` back.  Where a
replicated tensor enters a computation that differs by rank (a rank's
slice of the sequence, its own experts), ``enter`` (the identity, its
backward a ``psum`` of the partial cotangents) and ``scatter`` (the rank's
slice, its backward an ``all_gather`` of the slices' cotangents) make its
gradient whole again.  ``ppermute`` and ``broadcast`` carry no gradient.
"""
from __future__ import annotations

import time

import torch

from repro_torch.distributed.ranks import to_host
from repro_torch.launch.mesh import dp_axes_of

_HALF = (torch.bfloat16, torch.float16)


def _data_part(ctx, axes) -> tuple:
    """The data-parallel axes among ``axes``."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in names if a in dp_axes_of(ctx.mesh))


# ------------------------------------------------------------------ transport
def _exchange(ctx, x: torch.Tensor, run, dtype=None) -> torch.Tensor:
    """``run(h)`` on the host copy ``h`` of ``x`` (its exchange, returning
    the host result), back on ``x``'s device in its dtype.  The rank's
    ``ctx.wire`` counts it: the bytes handed to gloo and the host seconds
    from the device-to-host copy (after the device has finished
    computing ``x``) to the exchange's end."""
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    h = to_host(x, dtype=dtype)
    out = run(h)
    ctx.wire.add(h.numel() * h.element_size(), time.perf_counter() - t0)
    return out.to(x.device, x.dtype, non_blocking=True)


def _sum_dtype(x: torch.Tensor):
    return torch.float32 if x.dtype in _HALF else x.dtype


def raw_psum(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """Sum over the group (no gradient)."""
    group = ctx.group(axes)
    if group is None:
        return x

    def run(h):
        group.allreduce([h]).wait()
        return h
    return _exchange(ctx, x, run, _sum_dtype(x))


def raw_all_gather(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group order (no gradient)."""
    group = ctx.group(axes)
    if group is None:
        return x[None]

    def run(h):
        outs = [torch.empty_like(h) for _ in range(ctx.size(axes))]
        group.allgather([outs], [h]).wait()
        return torch.stack(outs)
    return _exchange(ctx, x, run)


def raw_all_to_all(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """Block k of dim 0 (of n equal blocks) to rank k; block k of the
    result from rank k (no gradient)."""
    group = ctx.group(axes)
    if group is None:
        return x
    if x.shape[0] % ctx.size(axes):
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split into {ctx.size(axes)} blocks")

    def run(h):
        out = torch.empty_like(h)
        group.alltoall_base(out, h, [], []).wait()
        return out
    return _exchange(ctx, x, run)


# ------------------------------------------------------------------ autograd
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, scale):
        fctx.ctx, fctx.axes, fctx.scale = ctx, axes, scale
        out = raw_psum(x, ctx, axes)
        return out * scale if scale != 1 or out is x else out

    @staticmethod
    def backward(fctx, g):
        data = _data_part(fctx.ctx, fctx.axes)
        if data:
            g = raw_psum(g.contiguous(), fctx.ctx, data)
        return (g * fctx.scale if fctx.scale != 1 else g), None, None, None


def psum(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """Sum over the group, the result replicated over it."""
    return _PSum.apply(x, ctx, axes, 1)


def pmean(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """Mean over the group, the result replicated over it."""
    return _PSum.apply(x, ctx, axes, 1.0 / ctx.size(axes))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.ctx, fctx.axes, fctx.dim = ctx, axes, dim
        stacked = raw_all_gather(x.contiguous(), ctx, axes)
        return torch.cat(stacked.unbind(0), dim=dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, dim = fctx.ctx, fctx.axes, fctx.dim
        data = _data_part(ctx, axes)
        if data:
            g = raw_psum(g.contiguous(), ctx, data) / ctx.size(data)
        n = g.shape[dim] // ctx.size(axes)
        return g.narrow(dim, ctx.index(axes) * n, n), None, None, None


def all_gather(x: torch.Tensor, ctx, axes, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in group order: stacked on a new leading dim (no
    gradient), or with ``tiled`` concatenated along ``dim``."""
    if not tiled:
        return raw_all_gather(x.contiguous(), ctx, axes)
    return _AllGather.apply(x, ctx, axes, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.ctx, fctx.axes = ctx, axes
        return raw_all_to_all(x.contiguous(), ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return raw_all_to_all(g.contiguous(), fctx.ctx, fctx.axes), None, \
            None


def all_to_all(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, split_axis=0, concat_axis=0,
    tiled=True)``: dim 0 in n blocks, block k to rank k, the result's
    block k from rank k."""
    return _AllToAll.apply(x, ctx, axes)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.ctx, fctx.axes = ctx, axes
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return raw_psum(g.contiguous(), fctx.ctx, fctx.axes), None, None


def enter(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """``x``, replicated over ``axes``, entering a computation whose result
    differs by rank: the identity, its gradient summed over the group."""
    return _Enter.apply(x, ctx, axes)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.ctx, fctx.axes, fctx.dim = ctx, axes, dim
        n = x.shape[dim] // ctx.size(axes)
        return x.narrow(dim, ctx.index(axes) * n, n).contiguous()

    @staticmethod
    def backward(fctx, g):
        stacked = raw_all_gather(g.contiguous(), fctx.ctx, fctx.axes)
        return torch.cat(stacked.unbind(0), dim=fctx.dim), None, None, None


def scatter(x: torch.Tensor, ctx, axes, dim: int) -> torch.Tensor:
    """The rank's slice along ``dim`` of ``x``, replicated over ``axes``;
    its gradient is every slice's, gathered."""
    n = ctx.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"scatter: dim {dim} of {tuple(x.shape)} does not "
                         f"split into {n}")
    return _Scatter.apply(x, ctx, axes, dim)


# ------------------------------------------------------------------ no grad
def ppermute(x: torch.Tensor, ctx, axes, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` with the pairs (i, i + shift): the rank at
    index i sends ``x`` to index i + shift and receives from i - shift;
    a rank with no sender gets zeros (no wrap, as the reference's
    pipeline)."""
    group = ctx.group(axes)
    if group is None:
        return torch.zeros_like(x)
    n, i = ctx.size(axes), ctx.index(axes)

    def run(h):
        works, got = [], torch.zeros_like(h)
        if 0 <= i + shift < n:
            works.append(group.send([h], i + shift, 0))
        if 0 <= i - shift < n:
            works.append(group.recv([got], i - shift, 0))
        for w in works:
            w.wait()
        return got
    return _exchange(ctx, x, run)


def broadcast(x: torch.Tensor, ctx, axes, root: int) -> torch.Tensor:
    """The group's rank ``root``'s ``x`` on every rank of the group
    (``x`` elsewhere gives only its shape and dtype)."""
    group = ctx.group(axes)
    if group is None:
        return x

    def run(h):
        group.broadcast(h, root).wait()
        return h
    return _exchange(ctx, x, run)
