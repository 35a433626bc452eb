"""The rank pool: one process a rank over a mesh, in gloo groups.

The reference runs a ``shard_map`` body once per device from one
controller.  The port runs PyTorch's idiom for it: SPMD processes.  A
``RankPool`` starts ``n`` processes with the ``spawn`` context; a call
``pool.run(fn, mesh, per_rank_args)`` runs the importable ``fn(ctx,
*args)`` on the first ``mesh.size`` of them and returns their results in
rank order.  ``run_ranks`` is a pool for one call.

``ctx`` (``RankContext``) is what a body reads in place of the axis names:
the rank's device, its coordinate on each mesh axis, and one gloo group
for every set of axes a body reduces over (every non-empty subset of the
mesh's axes, built at a mesh's first call over a prefixed store and kept
for the next).  Rank r's coordinates are rank-major over the mesh's axes
in order, as ``launch.mesh.Mesh`` lays out its devices; ranks go
round-robin over the CUDA devices (``launch.mesh.rank_devices``: two ranks
on one H100 share ``cuda:0``) or all run on the CPU.

Each rank runs one intra-op thread.  Arguments and results cross a pipe serialized by ``torch.save`` in 4 MiB
messages (``send_tree``); a result's tensors arrive on the CPU.  A rank
that raises sends its traceback and exits; a rank that exits or sends
nothing within ``timeout_s`` is noticed too; either way every rank of the
pool is then stopped and the call raises with the failing ranks'
tracebacks.  Each group has the same finite timeout, so a rank waiting on
a dead peer raises rather than hangs.  No process outlives ``close()``
(or the pool's collection, or the interpreter).

On CUDA the kernels are built in the calling process before any rank
starts, so that ranks do not race on the build directory.

The tensor-parallel serving backend (``inference.backends.sharded``)
starts, commands and stops its worker ranks with the same code
(``Workers``, ``start_rank``, ``join_store``, ``serve_commands``,
``gloo_group``, ``send_tree`` / ``recv_tree``), its rank 0 staying in the
caller, and stages its all-reduces through ``to_host`` as
``distributed.collectives`` does.
"""
from __future__ import annotations

import datetime
import io
import itertools
import math
import multiprocessing as mp
import os
import time
import traceback
import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (Mesh, axes_index, rank_coords,
                                    rank_devices)

HOST = "127.0.0.1"
_CHUNK = 1 << 22     # bytes a pipe message carries when a tree crosses


def gloo_group(store, rank: int, size: int, timeout_s: float):
    """A gloo group of its own over ``store`` (not the default group, so
    one process can belong to several), on the loopback."""
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=HOST)]
    return dist.ProcessGroupGloo(store, rank, size, opts)


def send_tree(conn, tree) -> None:
    """``tree`` serialized, across ``conn`` in messages of _CHUNK bytes:
    the reader of one message asks for all its remaining bytes in every
    read, and a tree of gigabytes sent whole did not arrive in minutes."""
    buf = io.BytesIO()
    torch.save(tree, buf)
    view = buf.getbuffer()
    conn.send(len(view))
    for i in range(0, len(view), _CHUNK):
        conn.send_bytes(view[i:i + _CHUNK])


def recv_tree(conn, device, weights_only: bool = True):
    """The tree ``send_tree`` sent, its tensors on ``device``.  Only the
    pool's own processes write these bytes; ``weights_only=False`` lets
    functions' arguments hold configs and other plain objects."""
    n = conn.recv()
    buf = bytearray(n)
    got = 0
    while got < n:
        got += conn.recv_bytes_into(buf, got)
    return torch.load(io.BytesIO(buf), map_location=device,
                      weights_only=weights_only)


def stop_processes(procs: list, conns: list) -> None:
    """Ask each process to close, then end whatever still runs."""
    for c in conns:
        try:
            c.send(("close", ()))
        except (OSError, ValueError):
            pass
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    for c in conns:
        c.close()


# ------------------------------------------------------------------ context
def mesh_axes(mesh, axes) -> tuple:
    """``axes`` (a name or a sequence of names) as a tuple in the mesh's
    axis order; raises for a name the mesh lacks."""
    want = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in want:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} not in mesh {dict(mesh.shape)}")
    return tuple(a for a in mesh.shape if a in want)


@dataclass
class WireStats:
    """A rank's exchanges (``distributed.collectives``): their count, the
    payload bytes it handed to gloo, and the host seconds from each
    staged copy to the exchange's end."""
    exchanges: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def add(self, nbytes: int, seconds: float) -> None:
        self.exchanges += 1
        self.bytes += nbytes
        self.seconds += seconds


@dataclass
class RankContext:
    """One rank's view of the mesh: its device and coordinates, its group
    (None when of size 1) over every non-empty subset of axes, and its
    exchanges so far."""
    rank: int
    mesh: Mesh
    device: torch.device
    coords: dict
    groups: dict = field(default_factory=dict)
    wire: WireStats = field(default_factory=WireStats)

    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a]
                         for a in mesh_axes(self.mesh, axes))

    def index(self, axes) -> int:
        """This rank's index in its group over ``axes`` (row-major)."""
        return axes_index(self.mesh, self.coords,
                          mesh_axes(self.mesh, axes))

    def group(self, axes):
        return self.groups[mesh_axes(self.mesh, axes)]


def _mesh_key(mesh) -> str:
    return ",".join(f"{a}={n}" for a, n in mesh.shape.items())


def make_context(store, mesh, rank: int, device, timeout_s: float
                 ) -> RankContext:
    """Rank ``rank``'s context, its groups built over ``store`` (every
    rank of the mesh builds the same groups in the same order)."""
    ctx = RankContext(rank, mesh, device, rank_coords(mesh, rank))
    names = tuple(mesh.shape)
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            size = math.prod(mesh.shape[a] for a in axes)
            if size == 1:
                ctx.groups[axes] = None
                continue
            rest = tuple(a for a in names if a not in axes)
            tag = "/".join((_mesh_key(mesh), "+".join(axes),
                            str(axes_index(mesh, ctx.coords, rest))))
            ctx.groups[axes] = gloo_group(
                dist.PrefixStore(tag, store),
                axes_index(mesh, ctx.coords, axes), size, timeout_s)
    return ctx


# ------------------------------------------------------------------ ranks
def start_rank(device: str, threads: int, tf32: tuple) -> torch.device:
    """A rank process's set-up: ``threads`` intra-op threads, the
    caller's TF32 choice (so that every rank's f32 products round alike)
    and its device made current.  Returns the device."""
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def tf32_choice() -> tuple:
    """This process's TF32 settings, for ``start_rank``."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def join_store(port: int, world: int, timeout_s: float):
    """A client of the caller's TCPStore on ``port``."""
    return dist.TCPStore(HOST, port, world, False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def serve_commands(conn, handle, trees: bool = False) -> None:
    """A rank's command loop: ``handle(op, args)`` for each command the
    caller sends, replying ("ok", result), or with ``trees`` ("ok", None)
    and the result by ``send_tree``; on an exception it replies ("err",
    traceback) and returns, so that the rank exits and a peer waiting in
    a collective sees it gone.  Ends on "close" or when the caller's end
    of the pipe closes."""
    while True:
        try:
            op, args = conn.recv()
        except (EOFError, OSError):
            return
        if op == "close":
            conn.send(("ok", None))
            conn.close()
            # nothing to flush: skip the interpreter's teardown of the
            # groups and of torch, which takes most of a second
            os._exit(0)
        try:
            out = handle(op, args)
            if trees:
                conn.send(("ok", None))
                send_tree(conn, out)
            else:
                conn.send(("ok", out))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
            return


def to_host(x: torch.Tensor, host: torch.Tensor | None = None,
            dtype=None) -> torch.Tensor:
    """A contiguous host copy of ``x`` (in ``dtype``) that gloo may write
    into: for a CUDA ``x`` in ``host`` (a pinned buffer of its shape) or
    a new pinned buffer, once the device has written it."""
    dtype = dtype or x.dtype
    if x.device.type != "cuda":
        return x.detach().to(dtype).contiguous().clone()
    if host is None:
        host = torch.empty(x.shape, dtype=dtype, pin_memory=True)
    host.copy_(x.detach(), non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


class Workers:
    """The caller's side of spawned rank processes: each runs
    ``target(conn, *args[i])`` and answers on its pipe.  Worker i is
    named ``label`` ``first + i`` in errors.  ``close()`` (or the
    object's collection, or the interpreter's exit) stops them all."""

    def __init__(self, target, args: list, *, timeout_s: float,
                 label: str = "rank", first: int = 0):
        self.timeout_s = timeout_s
        self.label, self.first = label, first
        self.procs, self.conns = [], []
        self._finalizer = weakref.finalize(self, stop_processes, self.procs,
                                           self.conns)
        ctx = mp.get_context("spawn")
        try:
            for i, a in enumerate(args):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=target, args=(child, *a),
                                daemon=True, name=f"{label}{first + i}"
                                .replace(" ", "-"))
                p.start()
                child.close()
                self.procs.append(p)
                self.conns.append(parent)
        except BaseException:
            self.close()
            raise

    def _name(self, i: int) -> str:
        return f"{self.label} {self.first + i}"

    def send(self, op: str, *args) -> None:
        for c in self.conns:
            c.send((op, args))

    def gather(self, workers=None, trees: bool = False) -> list:
        """Each worker's reply (of ``workers``, all by default) in order.
        On the first failure (an error sent, a worker gone, the timeout)
        it waits a moment for the others' errors and raises with all of
        them."""
        workers = list(range(len(self.procs)) if workers is None
                       else workers)
        out, pending, failures = {}, list(workers), []
        deadline = time.monotonic() + self.timeout_s
        while pending:
            for i in list(pending):
                p, c = self.procs[i], self.conns[i]
                if c.poll():
                    try:
                        status, value = c.recv()
                    except (EOFError, OSError):       # it closed the pipe
                        p.join(timeout=5)
                        status, value = "exit", None
                    if status == "exit":
                        failures.append(f"{self._name(i)} exited (code "
                                        f"{p.exitcode})")
                    elif status != "ok":
                        failures.append(f"{self._name(i)} failed:\n{value}")
                    else:
                        out[i] = recv_tree(c, "cpu", weights_only=False) \
                            if trees else value
                    pending.remove(i)
                elif not p.is_alive() and not c.poll():
                    failures.append(f"{self._name(i)} exited (code "
                                    f"{p.exitcode})")
                    pending.remove(i)
            if failures:
                raise RuntimeError("\n".join(failures + self.errors(pending)))
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{', '.join(self._name(i) for i in pending)} sent no "
                    f"reply in {self.timeout_s} s")
            if pending:
                self.conns[pending[0]].poll(0.05)
        return [out[i] for i in workers]

    def errors(self, workers=None, wait_s: float = 2.0) -> list:
        """The tracebacks (or exits) of ``workers`` (all by default)
        within ``wait_s``, after another rank failed."""
        msgs = []
        deadline = time.monotonic() + wait_s
        for i in range(len(self.procs)) if workers is None else workers:
            c, p = self.conns[i], self.procs[i]
            try:
                while c.poll(max(0.0, deadline - time.monotonic())):
                    msg = c.recv()
                    if isinstance(msg, tuple) and msg[0] == "err":
                        msgs.append(f"{self._name(i)} failed:\n{msg[1]}")
                        break
            except (EOFError, OSError):
                p.join(timeout=5)
                msgs.append(f"{self._name(i)} exited (code {p.exitcode})")
            except Exception:        # the raw bytes of a result's tree
                pass
        return msgs

    def close(self) -> None:
        """Stop every worker (idempotent)."""
        self._finalizer()


def _rank_main(conn, rank: int, port: int, n: int, timeout_s: float,
               device: str, tf32: tuple) -> None:
    """Rank ``rank`` of a pool: join the caller's store, then run each
    function it is sent on the context of the mesh it names."""
    dev = start_rank(device, 1, tf32)
    try:
        store = join_store(port, n + 1, timeout_s)
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    conn.send(("ok", None))
    contexts: dict = {}

    def run(op, args):
        fn, mesh = args
        fn_args = recv_tree(conn, dev, weights_only=False)
        key = _mesh_key(mesh)
        if key not in contexts:
            contexts[key] = make_context(store, mesh, rank, dev, timeout_s)
        out = fn(contexts[key], *fn_args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    serve_commands(conn, run, trees=True)


class RankPool:
    """``n`` rank processes; ``run`` calls a function on the first
    ``mesh.size`` of them.  Use as a context manager or ``close()`` it."""

    def __init__(self, n: int, device="cuda", *, timeout_s: float = 300.0):
        if n < 1:
            raise ValueError(f"a rank pool needs n >= 1, got {n}")
        self.n = n
        self.device = resolve_device(device)
        self.devices = rank_devices(n, self.device)
        self.timeout_s = timeout_s
        self.closed = False
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build()
        td = datetime.timedelta(seconds=timeout_s)
        self._store = dist.TCPStore(HOST, 0, n + 1, True, timeout=td,
                                    wait_for_workers=False)
        tf32 = tf32_choice()
        self._workers = Workers(
            _rank_main, [(r, self._store.port, n, timeout_s,
                          str(self.devices[r]), tf32) for r in range(n)],
            timeout_s=timeout_s)
        try:
            self._workers.gather()
        except BaseException:
            self.close()
            raise

    @property
    def procs(self) -> list:
        """The rank processes, in rank order."""
        return self._workers.procs

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn, mesh, per_rank_args) -> list:
        """``fn(ctx, *per_rank_args[r])`` on rank r of ``mesh`` for every
        r; their results in rank order (tensors on the CPU).  ``fn`` must
        be importable (it is pickled by reference)."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        if mesh.size > self.n:
            raise ValueError(f"mesh {dict(mesh.shape)} needs {mesh.size} "
                             f"ranks; the pool has {self.n}")
        if len(per_rank_args) != mesh.size:
            raise ValueError(f"{len(per_rank_args)} argument tuples for "
                             f"{mesh.size} ranks")
        ranks = range(mesh.size)
        conns = self._workers.conns
        try:
            for r in ranks:
                conns[r].send(("run", (fn, mesh)))
                send_tree(conns[r], tuple(per_rank_args[r]))
            return self._workers.gather(ranks, trees=True)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop every rank (idempotent)."""
        self.closed = True
        workers = getattr(self, "_workers", None)
        if workers is not None:
            workers.close()


def run_ranks(fn, mesh, per_rank_args, device="cuda", *,
              timeout_s: float = 300.0) -> list:
    """``fn(ctx, *per_rank_args[r])`` on every rank of ``mesh``, each in a
    process of its own that ends with the call; the results in rank
    order."""
    with RankPool(mesh.size, device, timeout_s=timeout_s) as pool:
        return pool.run(fn, mesh, per_rank_args)
