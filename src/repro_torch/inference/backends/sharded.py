"""Tensor-parallel sharded execution backend (Megatron-style, one process
a rank).

Counterpart of ``repro/inference/backends/sharded.py``.  The reference runs
its step bodies under ``shard_map`` from one controller; the port runs
PyTorch's idiom for it: ``tp`` processes, one a rank, in a
``torch.distributed`` gloo group.  The caller's process is rank 0: it holds
the engine, the scheduler, a speculative draft and the host argmax, and
this backend.  Ranks 1..tp-1 are worker processes started with the
``spawn`` context (``_worker_main``), each given only its own shard.

Placement is the reference's (``distributed.sharding``): wq/wk/wv (and
their biases) column-sharded by head, wo row-sharded, the MLP's d_ff
split; the embedding and the LM head replicated; the KV caches, contiguous
and paged (an int8 pool's scales too), head-sharded.  Every rank runs the
same step bodies (``bodies.make_step_bodies``) with its LOCAL config
(``n_heads/tp``, ``n_kv_heads/tp``, ``head_dim`` pinned) and a ``reduce``
hook that all-reduces each attention and MLP partial output in place, so
every rank holds the same activations between blocks and emits the logits
a single device would.

A pipe to each worker carries the calls, in order: the six step kinds, the
two cache inits, every page op the engine makes on the paged pool
(``PagedKVCache.mirror``: ``zero_pages``, ``copy_pages``, ``gather_host``,
``scatter_host``) and the engine's ``reset`` (``reset_cache``).  The group
carries only the all-reduces.  A worker's exception comes back through its
pipe and raises in rank 0 (the worker then exits, so a rank 0 waiting in
an all-reduce sees its peer gone); the group has a finite ``timeout_s``,
so a rank that stops raises rather than hangs; on any failure rank 0
stops its workers and the backend is closed.  Workers exit on ``close()``
and when rank 0's end of their pipe closes.

Execution (``plan="jit"`` only, as the reference's):
  * on the CPU each rank runs the bodies directly, the all-reduce inline;
  * on CUDA gloo cannot be captured in a CUDA graph, so each body is
    captured as graph segments split at its reduce sites: in the capture
    pass the hook ends the current segment and begins the next in the same
    memory pool, returning the partial's own tensor (the all-reduce is in
    place, and the next segment reads that address).  A replay is
    ``replay(seg_0)``, all-reduce ``buf_0``, ``replay(seg_1)``, ...: a dense
    stack of L layers takes 2L + 1 replays and 2L all-reduces a step on
    every rank.  The all-reduce stages the partial through a pinned host
    buffer (device to host, the gloo exchange, host to device): transport
    only, all compute stays on the card.  The warm-up before a capture
    runs with real all-reduces on every rank.  The ranks capture and
    replay the same signatures in the same order: a graph is keyed on the
    signature and on the cache the backend built (not its addresses, which
    differ between ranks).  A failed capture, build or all-reduce raises.

With fewer GPUs than ranks, ranks share a card (``launch.mesh``): on one
H100 both ranks of tp=2 live on ``cuda:0`` and ``BackendInfo.devices`` is
``(0, 0)``.  Their step times are then no tensor-parallel speed: the ranks
time-share the card and their all-reduces cross host memory.

Accounting is the reference's, formula for formula: each call is charged
``dispatches = tp`` (one a rank's stream), and every all-reduce the body
issues, as a name and its payload bytes, recorded on the first call of
each signature (the counterpart of the reference's trace time) and priced
over the platform's link by ``core.device_model.allreduce_cost_s``.  The
port keeps its layers unstacked, so it counts every layer's reduce
directly: the reference's ``len(profile) * n_superblocks``.
"""
from __future__ import annotations

import datetime
import importlib
import io
import multiprocessing as mp
import os
import time
import traceback
import weakref
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device_model import PLATFORMS, allreduce_cost_s
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard_params
from repro_torch.inference.backends.base import (AccountingMixin,
                                                 BackendInfo, CallAccount)
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.inference.backends.local import (GraphStats, LocalBackend,
                                                  StepCalls, TraceStats)
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import make_paged_cache

_SUPPORTED_KINDS = ("attn", "attn_local")
_HOST = "127.0.0.1"


def _validate_tp(cfg: ModelConfig, tp: int) -> None:
    """Reject configs the head-sharded bodies cannot serve (the
    reference's checks and words)."""
    if tp < 2:
        raise ValueError(f"ShardedBackend needs tp >= 2, got {tp} "
                         "(use LocalBackend for single-device serving)")
    bad = [k for k in cfg.block_pattern if k not in _SUPPORTED_KINDS]
    if bad or cfg.moe_slots or cfg.n_encoder_layers:
        raise ValueError(
            f"ShardedBackend supports pure-attention decoder stacks; "
            f"{cfg.name} has block kinds {bad or cfg.block_pattern}, "
            f"moe_slots={cfg.moe_slots}, "
            f"n_encoder_layers={cfg.n_encoder_layers}")
    for dim, val in (("n_heads", cfg.n_heads),
                     ("n_kv_heads", cfg.n_kv_heads),
                     ("d_ff", cfg.d_ff)):
        if val % tp:
            raise ValueError(
                f"tp={tp} must divide {dim}={val} for {cfg.name}: the "
                f"shard_map body runs {dim}//tp per device (pick a tp "
                f"from the divisors of {val}, or serve this arch with "
                f"tp=1)")


def _check_plan(plan: str) -> None:
    if plan != "jit":
        raise ValueError(
            f"ShardedBackend executes plan='jit' only (got {plan!r}): "
            "the launch-plan runtime replays single-device kernel "
            "streams and cannot re-dispatch shard_map bodies; "
            "per-device launch pricing for tp>1 comes from "
            "Planner(tp=...) / telemetry.characterize.tp_sweep")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """One rank's view: local head counts, ``head_dim`` pinned (d_model //
    local heads would be wrong)."""
    return cfg.replace(n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp, head_dim=cfg.hd)


def _group(store, rank: int, tp: int, timeout_s: float):
    """A gloo group of its own over ``store`` (not the default group, so
    one process can be rank 0 of several backends), on the loopback."""
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=_HOST)]
    return dist.ProcessGroupGloo(store, rank, tp, opts)


@dataclass
class CollectiveStats:
    """One rank's all-reduces, their payload bytes and the host seconds in
    the gloo exchange (each waits for the peer ranks to reach it too)."""
    allreduces: int = 0
    allreduce_bytes: int = 0
    allreduce_s: float = 0.0


class _Rank(LocalBackend):
    """One rank's shard of the step bodies: ``LocalBackend``'s signatures,
    staging and graph capture over the local config, with the all-reduce
    at every reduce site (on CUDA between the graph segments the capture
    cut there)."""

    def __init__(self, cfg_local: ModelConfig, shard, *, group,
                 max_batch: int, max_len: int, device, platform: str):
        super().__init__(cfg_local, shard, max_batch=max_batch,
                         max_len=max_len, plan="jit", device=device,
                         platform=platform)
        self.group = group
        self._bodies = make_step_bodies(cfg_local, reduce=self._reduce)
        self.sites: list = []         # (name, bytes) of the reduce sites
        self.coll = CollectiveStats()
        self._own: tuple = ()         # ids of the cache's leaves
        self._gen = 0                 # caches built so far

    # ------------------------------------------------------------ caches
    def adopt(self, cache) -> list:
        """Serve ``cache`` from now on; every rank's graphs of an earlier
        cache stop matching at once."""
        self._own = tuple(id(t) for layer in cache for t in layer.values())
        self._leaves = [t for layer in cache for t in layer.values()]
        self._gen += 1
        return cache

    def _cache_key(self, cache) -> tuple:
        if tuple(id(t) for layer in cache for t in layer.values()) \
                != self._own:
            raise ValueError("a tensor-parallel rank serves only the cache "
                             "its backend built (init_contiguous_cache / "
                             "init_paged_cache)")
        return (self._gen,)

    # ------------------------------------------------------------ reduce
    def _reduce(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The bodies' hook.  In a capture pass a segment ends here and the
        partial's own tensor goes on (``_reduce_replayed`` all-reduces it
        in place between the replays); in a direct run (the CPU, or the
        warm-up before a capture) it is all-reduced now and its site
        recorded."""
        if self._cuts is not None:
            self._cuts.cut(x)
            return x
        self.sites.append((name, x.numel() * x.element_size()))
        if x.device.type == "cuda":
            h = x.cpu()
            self._exchange(h)
            x.copy_(h)
        else:
            self._exchange(x)
        return x

    def _reduce_replayed(self, buf: torch.Tensor,
                         host: torch.Tensor) -> None:
        """All-reduce ``buf`` through its pinned ``host`` buffer (device to
        host, the gloo exchange, host to device): transport only."""
        host.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self._exchange(host)
        buf.copy_(host, non_blocking=True)

    def _exchange(self, h: torch.Tensor) -> None:
        t0 = time.perf_counter()
        self.group.allreduce([h]).wait()
        c = self.coll
        c.allreduce_s += time.perf_counter() - t0
        c.allreduces += 1
        c.allreduce_bytes += h.numel() * h.element_size()


# ---------------------------------------------------------------- workers
_CHUNK = 1 << 22     # bytes a pipe message carries when a shard crosses


def _send_tree(conn, tree) -> None:
    """``tree`` serialized, across ``conn`` in messages of _CHUNK bytes:
    the reader of one message asks for all its remaining bytes in every
    read, and a shard of gigabytes sent whole did not arrive in minutes."""
    buf = io.BytesIO()
    torch.save(tree, buf)
    view = buf.getbuffer()
    conn.send(len(view))
    for i in range(0, len(view), _CHUNK):
        conn.send_bytes(view[i:i + _CHUNK])


def _recv_tree(conn, device):
    n = conn.recv()
    buf = bytearray(n)
    got = 0
    while got < n:
        got += conn.recv_bytes_into(buf, got)
    return torch.load(io.BytesIO(buf), map_location=device,
                      weights_only=True)


def _exchanges(group, n: int, nbytes: int) -> float:
    """Seconds one of ``n`` back-to-back all-reduces of ``nbytes`` of host
    memory takes (no device work between them), after one untimed to line
    the ranks up."""
    h = torch.zeros(max(nbytes // 4, 1))
    group.allreduce([h]).wait()
    t0 = time.perf_counter()
    for _ in range(n):
        group.allreduce([h]).wait()
    return (time.perf_counter() - t0) / n


def _worker_main(conn, rank: int, tp: int, port: int, timeout_s: float,
                 cfg_local: ModelConfig, max_batch: int, max_len: int,
                 device: str, platform: str, threads: int,
                 tf32: tuple) -> None:
    """Rank ``rank``: receive its shard, join the group, then run each
    command from rank 0 in order, replying ("ok", result) or ("err",
    traceback); after an error it exits, so that a peer waiting in an
    all-reduce sees it gone.  Ends on "close" or when rank 0's end of the
    pipe closes."""
    torch.set_num_threads(threads)
    # rank 0's TF32 choice, so that every rank's f32 products round alike
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        shard = _recv_tree(conn, dev)
        store = dist.TCPStore(_HOST, port, tp, False,
                              timeout=datetime.timedelta(seconds=timeout_s))
        me = _Rank(cfg_local, shard, group=_group(store, rank, tp, timeout_s),
                   max_batch=max_batch, max_len=max_len, device=dev,
                   platform=platform)
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    conn.send(("ok", None))
    # the custom ops import dynamo at their first call: take that while
    # rank 0 goes on setting up, not inside the first step
    importlib.import_module("torch._dynamo")
    cache, kv, staged = None, None, {}
    while True:
        try:
            op, args = conn.recv()
        except (EOFError, OSError):
            return
        if op == "close":
            conn.send(("ok", None))
            conn.close()
            # nothing to flush: skip the interpreter's teardown of the
            # group and of torch, which takes most of a second
            os._exit(0)
        try:
            out = None
            if op == "call":
                kind, arrays, static = args
                me._call(kind, cache, arrays, static)
                out = (dict(me.last.kernel_launches), replace(me.coll),
                       replace(me.graph_stats))
            elif op == "contiguous":
                cache = me.adopt(me.init_contiguous_cache())
            elif op == "paged":
                kv = PagedKVCache(cfg_local, device=dev, **args[0])
                cache = me.adopt(kv.make_pages())
            elif op == "zero_pages":
                kv.zero_pages(cache, args[0])
            elif op == "copy_pages":
                kv.copy_pages(cache, *args)
            elif op == "gather_host":
                staged[args[1]] = kv.gather_host(cache, args[0])
            elif op == "scatter_host":
                kv.scatter_host(cache, args[0], staged.pop(args[1]))
            elif op == "reset_cache":
                me.reset_cache(cache)
                staged.clear()
            elif op == "exchange":
                _exchanges(me.group, *args)
            else:
                raise ValueError(f"unknown command {op!r}")
            conn.send(("ok", out))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
            return


class _Workers:
    """Rank 0's side of the workers: their processes and pipes."""

    def __init__(self, procs: list, conns: list, timeout_s: float):
        self.procs = procs
        self.conns = conns
        self.timeout_s = timeout_s

    def send(self, op: str, *args) -> None:
        for c in self.conns:
            c.send((op, args))

    def gather(self) -> list:
        """Each worker's reply to the last command; raises with a worker's
        traceback, when a worker exited, or past the timeout."""
        out = []
        for r, (p, c) in enumerate(zip(self.procs, self.conns), start=1):
            deadline = time.monotonic() + self.timeout_s
            while not c.poll(0.5):
                if not p.is_alive():
                    raise RuntimeError(f"tensor-parallel rank {r} exited "
                                       f"(code {p.exitcode})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"tensor-parallel rank {r} sent no "
                                       f"reply in {self.timeout_s} s")
            status, value = c.recv()
            if status != "ok":
                raise RuntimeError(f"tensor-parallel rank {r} failed:\n"
                                   f"{value}")
            out.append(value)
        return out

    def errors(self, wait_s: float = 2.0) -> str:
        """The tracebacks the workers sent, waiting up to ``wait_s`` for
        them (after rank 0 failed)."""
        msgs = []
        deadline = time.monotonic() + wait_s
        for r, c in enumerate(self.conns, start=1):
            try:
                while c.poll(max(0.0, deadline - time.monotonic())):
                    status, value = c.recv()
                    if status != "ok":
                        msgs.append(f"rank {r}:\n{value}")
                        break
            except (EOFError, OSError):
                pass
        return "\n".join(msgs)


def _stop(procs: list, conns: list) -> None:
    """Ask each worker to close, then end whatever still runs."""
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


class ShardedBackend(StepCalls, AccountingMixin):
    """Head-sharded tensor-parallel backend over ``tp`` rank processes."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int,
                 max_len: int, tp: int, plan: str = "jit", device="cuda",
                 platform: str = "Intel+H100", timeout_s: float = 300.0):
        _check_plan(plan)
        _validate_tp(cfg, tp)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"backend device is {self.device}")
        self.cfg = cfg
        self.tp = tp
        self.B = max_batch
        self.T = max_len
        self.plan = plan
        self.platform = platform
        self.spec = PLATFORMS[platform]
        self.timeout_s = timeout_s
        self.mesh = make_host_mesh(data=1, model=tp, device=self.device)
        self.info = BackendInfo(
            kind="sharded", tp=tp,
            devices=tuple(d.index if d.type == "cuda" else d.type
                          for d in self.mesh.devices))
        self._init_accounting()
        self.cfg_local = local_config(cfg, tp)
        self._profiles: dict = {}       # signature -> ((name, bytes), ...)
        self.rank_launches: list = []   # each rank's launches, last call
        self.rank_launch_totals = [{} for _ in range(tp)]   # all calls
        self.rank_collectives: list = []  # each rank's CollectiveStats
        self.rank_graphs: list = []       # and GraphStats
        self.trace_stats = TraceStats()
        self._closed = False
        self._start(params)

    def _start(self, params) -> None:
        """Spawn ranks 1..tp-1, hand each its shard, join the group."""
        td = datetime.timedelta(seconds=self.timeout_s)
        self._store = dist.TCPStore(_HOST, 0, self.tp, True, timeout=td,
                                    wait_for_workers=False)
        ctx = mp.get_context("spawn")
        procs, conns = [], []
        self._workers = _Workers(procs, conns, self.timeout_s)
        self._finalizer = weakref.finalize(self, _stop, procs, conns)
        try:
            for r in range(1, self.tp):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker_main, name=f"tp-rank{r}", daemon=True,
                    args=(child, r, self.tp, self._store.port,
                          self.timeout_s, self.cfg_local, self.B, self.T,
                          str(self.mesh.devices[r]), self.platform,
                          torch.get_num_threads(),
                          (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)))
                p.start()
                child.close()
                procs.append(p)
                conns.append(parent)
                _send_tree(parent, shard_params(params, self.cfg, self.tp, r))
            group = _group(self._store, 0, self.tp, self.timeout_s)
            self._workers.gather()
            self.local = _Rank(self.cfg_local,
                               shard_params(params, self.cfg, self.tp, 0),
                               group=group, max_batch=self.B,
                               max_len=self.T, device=self.device,
                               platform=self.platform)
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ plumbing
    def _stream_key(self, d: int):
        return d                        # one dispatch stream a rank

    def _run(self, op: str, *args, local=None):
        """Send ``op`` to the workers, run rank 0's part (``local``), and
        gather the workers' replies; any failure closes the backend."""
        if self._closed:
            raise RuntimeError("the tensor-parallel backend is closed")
        try:
            self._workers.send(op, *args)
            out = local() if local is not None else None
            return out, self._workers.gather()
        except BaseException as e:
            extra = self._workers.errors()
            self.close()
            if extra:
                raise RuntimeError(f"{e}\n{extra}") from e
            raise

    def _mirror(self, op: str, *args) -> None:
        """``PagedKVCache.mirror``: the page op on every worker's shard."""
        self._run(op, *args)

    @property
    def params(self):
        """Rank 0's shard (the replicated leaves are the caller's)."""
        return self.local.params

    @property
    def graph_stats(self) -> GraphStats:
        """Rank 0's graph segments (each rank captures the same)."""
        return self.local.graph_stats

    # ------------------------------------------------------------ caches
    def init_contiguous_cache(self):
        """Fresh head-sharded contiguous cache on every rank; rank 0's."""
        cache, _ = self._run("contiguous", local=lambda: self.local.adopt(
            self.local.init_contiguous_cache()))
        return cache

    def init_paged_cache(self, kv):
        """Fresh head-sharded pools of ``kv``'s geometry on every rank;
        returns rank 0's and makes ``kv`` mirror its page ops to the
        others.  ``kv.pool.block_bytes`` prices a block's pages on every
        rank, as the reference's unsharded pytree does."""
        geom = dict(num_blocks=kv.num_blocks, block_size=kv.block_size,
                    max_len=kv.max_len, dtype=kv.dtype,
                    kv_dtype=kv.kv_dtype)

        def local():
            return self.local.adopt(make_paged_cache(
                self.cfg_local, kv.num_blocks, kv.block_size, kv.dtype,
                kv_dtype=kv.kv_dtype, device=self.device))
        pages, _ = self._run("paged", geom, local=local)
        kv.pool.block_bytes = kv.block_bytes(pages, 1) * self.tp
        kv.mirror = self._mirror
        return pages

    def reset_cache(self, cache) -> None:
        """Zero every rank's cache in place (and drop the workers' staged
        host pages)."""
        self._run("reset_cache", local=lambda: self.local.reset_cache(cache))

    # ------------------------------------------------------------ steps
    def _call(self, kind: str, cache, arrays: list, static: tuple):
        """One step on every rank; rank 0's logits (every rank's are the
        same).  Charged ``tp`` dispatches and the signature's all-reduces,
        priced over the platform link."""
        t0 = time.perf_counter()
        key = (kind, tuple(a.shape for a in arrays), static)
        self.local.sites = []
        (out, cache), replies = self._run(
            "call", kind, arrays, static,
            local=lambda: self.local._call(kind, cache, arrays, static))
        host = time.perf_counter() - t0
        if key not in self._profiles:
            self._profiles[key] = tuple(self.local.sites)
        prof = self._profiles[key]
        launches = dict(self.local.last.kernel_launches)
        self.rank_launches = [launches] + [r[0] for r in replies]
        for total, got in zip(self.rank_launch_totals, self.rank_launches):
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        self.rank_collectives = [replace(self.local.coll)] + [
            r[1] for r in replies]
        self.rank_graphs = [replace(self.local.graph_stats)] + [
            r[2] for r in replies]
        self._charge(CallAccount(
            dispatches=self.tp, host_time_s=host,
            collectives=len(prof),
            collective_bytes=sum(b for _, b in prof),
            modeled_collective_tax_s=sum(
                allreduce_cost_s(self.spec, b, self.tp) for _, b in prof),
            kernel_launches=launches))
        return out, cache

    def probe_exchange(self, n: int, nbytes: int) -> float:
        """Seconds a host-only all-reduce of ``nbytes`` takes between the
        ranks, over ``n`` back to back: the transport's own share of a
        step's all-reduces, without the device work and the waits for the
        other ranks' turns on a shared card around them."""
        out, _ = self._run("exchange", n, nbytes, local=lambda: _exchanges(
            self.local.group, n, nbytes))
        return out

    @property
    def planned_decode(self):
        """Launch-plan decode handle: always None (jit-only backend)."""
        return None

    def close(self) -> None:
        """Stop the workers (idempotent); the backend serves no more."""
        self._closed = True
        finalizer = getattr(self, "_finalizer", None)
        if finalizer is not None:
            finalizer()
