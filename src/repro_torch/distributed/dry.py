"""A dry rank and an op recorder: one rank's step body traced on meta
tensors, with no process group.

``dry_context(mesh, rank)`` is a ``RankContext`` whose group over every
set of axes is a ``RecordingGroup`` without a peer: each collective the
body calls (``distributed.collectives``) goes through the same code as on
a gloo rank (the host copy, the exchange, the copy back), records its
kind, payload bytes, group size and axes, and leaves its result tensor as
it was allocated, of the right shape.  ``record_groups(ctx)`` wraps a
real rank's gloo groups the same way, so a rank run and a dry trace give
the same record.

``OpRecorder`` (a ``TorchDispatchMode``) sees every aten op and custom op
the body issues, forward and backward, and keeps:

* the op stream (``ops``: the overloads' names, in order);
* FLOPs and bytes by ``core/costs.py``'s rules, a hand-written kernel's
  custom op by its wrapper's own ``costs`` (``kernels.OPS``); FLOPs are
  split by the dtype of the op's first floating operand (``lowp``: bf16
  or f16, the tensor cores' rate; ``f32``), views and allocations count
  nothing;
* with ``memory``, the live storages: the bytes of every storage an op
  creates from its creation until no tensor holds it (PyTorch's own use
  count of the storage), and the peak of the live bytes above the
  arguments (``register_arguments``), within ``PEAK_SLACK`` below the
  true one.  A storage kept by autograd for the backward stays live, as
  on the card.

A dry trace runs on meta tensors (``host_scalars`` makes the host
scalars real), inside ``kernels.build.dry_trace``: no byte is
allocated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import itertools

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.core.costs import op_costs
from repro_torch.distributed.ranks import RankContext, WireStats
from repro_torch.kernels import OPS
from repro_torch.launch.mesh import rank_coords
from repro_torch.tree import map_tree

_SCALAR = torch.ops.aten._local_scalar_dense.default
_LOWP = (torch.bfloat16, torch.float16)
PEAK_SLACK = 1 / 64
# ops that allocate or alias and move nothing
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "empty_like", "detach", "lift_fresh", "alias", "set_", "resize_",
         "record_stream"}


# ------------------------------------------------------------------ groups
@dataclass
class CollectiveLog:
    """Every collective of a rank: (kind, payload bytes, group size,
    axes), in order."""
    calls: list = field(default_factory=list)

    def add(self, kind: str, nbytes: int, size: int, axes: tuple) -> None:
        self.calls.append((kind, int(nbytes), int(size), tuple(axes)))


class _Done:
    def wait(self):
        return True


class _Quiet:
    """A real exchange's work, waited on with no dispatch mode active."""

    def __init__(self, work):
        self.work = work

    def wait(self):
        with _disable_current_modes():
            return self.work.wait()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class RecordingGroup:
    """A group over ``axes`` of ``size`` ranks that records each call in
    ``log`` and forwards it to ``group`` (None: a dry group, which moves
    nothing)."""

    def __init__(self, group, axes: tuple, size: int, log: CollectiveLog):
        self.group, self.axes, self.size, self.log = group, axes, size, log

    def _run(self, kind, nbytes, call):
        self.log.add(kind, nbytes, self.size, self.axes)
        if self.group is None:
            return _Done()
        # gloo's own allocations are not the body's ops
        with _disable_current_modes():
            return _Quiet(call())

    def allreduce(self, tensors):
        return self._run("all-reduce", _nbytes(tensors[0]),
                         lambda: self.group.allreduce(tensors))

    def allgather(self, outs, ins):
        return self._run("all-gather", _nbytes(ins[0]),
                         lambda: self.group.allgather(outs, ins))

    def alltoall_base(self, out, inp, split_out, split_in):
        return self._run("all-to-all", _nbytes(inp),
                         lambda: self.group.alltoall_base(
                             out, inp, split_out, split_in))

    def broadcast(self, t, root):
        return self._run("broadcast", _nbytes(t),
                         lambda: self.group.broadcast(t, root))

    def send(self, ts, dst, tag):
        return self._run("send", _nbytes(ts[0]),
                         lambda: self.group.send(ts, dst, tag))

    def recv(self, ts, src, tag):
        # the receive's bytes are its sender's send
        if self.group is None:
            return _Done()
        with _disable_current_modes():
            return _Quiet(self.group.recv(ts, src, tag))


def dry_context(mesh, rank: int, device="cpu") -> tuple:
    """(rank ``rank``'s dry context over ``mesh``, its collective log)."""
    log = CollectiveLog()
    ctx = RankContext(rank, mesh, torch.device(device),
                      rank_coords(mesh, rank))
    names = tuple(mesh.shape)
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            size = math.prod(mesh.shape[a] for a in axes)
            ctx.groups[axes] = None if size == 1 else \
                RecordingGroup(None, axes, size, log)
    ctx.wire = WireStats()
    return ctx, log


def record_groups(ctx) -> CollectiveLog:
    """Wrap a real rank's groups so that its collectives are recorded."""
    log = CollectiveLog()
    for axes, g in list(ctx.groups.items()):
        if g is not None:
            ctx.groups[axes] = RecordingGroup(
                g, axes, math.prod(ctx.mesh.shape[a] for a in axes), log)
    return log


def unwrap_groups(ctx) -> None:
    for axes, g in list(ctx.groups.items()):
        if isinstance(g, RecordingGroup):
            ctx.groups[axes] = g.group


# ------------------------------------------------------------------ ops
def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _packet(func) -> str:
    packet = getattr(func, "overloadpacket", None)
    return packet.__name__ if packet is not None else str(func)


class OpRecorder(TorchDispatchMode):
    """See the module's docstring."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.ops: list = []
        self.flops = {"lowp": 0.0, "f32": 0.0}
        self.bytes = 0.0
        self.memory = memory
        self._args: dict = {}        # storage id -> (storage, bytes)
        self._live: dict = {}
        self.live_bytes = 0          # with the frees not yet swept
        self.peak_bytes = 0
        self._next_sweep = 0

    # memory ------------------------------------------------------------
    def register_arguments(self, tree) -> int:
        """The storages of ``tree``'s tensors are the arguments; returns
        their bytes."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            self._args.setdefault(st._cdata, (st, st.nbytes()))
        return sum(n for _, n in self._args.values())

    def _sweep(self) -> None:
        for key in [k for k, (st, _) in self._live.items()
                    if torch._C._storage_Use_Count(k) <= 1]:
            self.live_bytes -= self._live.pop(key)[1]

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._args:
                continue
            self._live[key] = (st, st.nbytes())
            self.live_bytes += st.nbytes()
        if self.live_bytes > self._next_sweep:
            # the frees are found by a sweep over every live storage, so
            # a sweep runs only when the bytes (frees included) pass the
            # peak by PEAK_SLACK: the peak is exact within that share
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._next_sweep = self.peak_bytes * (1 + PEAK_SLACK)

    def is_argument(self, t) -> bool:
        return t.untyped_storage()._cdata in self._args

    # dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _SCALAR:
            # a host read of a scalar (``host_scalars``): no device op
            return out
        self.ops.append(str(func))
        name = _packet(func)
        hand = OPS.get(func)
        if hand is not None:
            fl, bt = hand[1](*args, **kwargs)
        elif name in _FREE or getattr(func, "is_view", False):
            fl, bt = 0.0, 0.0
        else:
            fl, bt = op_costs(name, args, kwargs, out)
        if fl:
            ins = [t for t in _tensors(args) if t.is_floating_point()]
            lowp = bool(ins) and ins[0].dtype in _LOWP
            self.flops["lowp" if lowp else "f32"] += fl
        self.bytes += bt
        if self.memory:
            self._track(out)
        return out


# ------------------------------------------------------------------ fakes
def host_scalars(tree):
    """``tree`` with every 0-d integer meta tensor (a step count, a cache
    index: host scalars the body reads) a real CPU zero; the other meta
    tensors stay as they are (shapes, strides and storage sizes: a cache
    leaf keeps its hidden scratch row)."""
    def conv(t):
        if isinstance(t, torch.Tensor) and t.device.type == "meta" and \
                t.dim() == 0 and not t.is_floating_point():
            return torch.zeros((), dtype=t.dtype)
        return t
    return map_tree(conv, tree)


def recorded_run(fn, ctx, *args):
    """``fn(ctx, *args)`` on a real rank under an ``OpRecorder``, its
    groups recording: (the op stream, the FLOPs by class, the bytes, the
    collective calls), for a comparison with a dry trace of the same
    body."""
    log = record_groups(ctx)
    rec = OpRecorder()
    try:
        with rec:
            fn(ctx, *args)
    finally:
        unwrap_groups(ctx)
    return rec.ops, rec.flops, rec.bytes, log.calls
