"""Single-device execution backend: the step bodies as CUDA graphs, or eager.

Counterpart of ``repro/inference/backends/local.py`` for the contiguous
and the paged cache (speculative verify is not ported yet, ROADMAP Queue A,
"speculative decoding").  Two plans:

  * ``"jit"``, the default as in the reference, is the counterpart of its
    ``jax.jit`` of the four bodies.  On a CUDA device each body call is
    looked up by its signature: the body, the shapes of its inputs, its
    shape-setting ints, and the address, shape, dtype and strides of every
    cache leaf (so a cache built anew is captured anew, never replayed
    against a stale address).  On a miss the body is warmed up on the
    backend's own capture stream, captured as one ``torch.cuda.CUDAGraph``
    in a memory pool of its own, and replayed.  On a hit one copy from a
    pinned staging buffer refreshes the graph's static inputs and one
    ``replay()`` runs the step.  The signature keeps static what the
    reference keeps static: a contiguous prefill keys on ``plen`` and the
    bucket (the slot is a device input), an RWKV prefill on its exact
    prompt length, a decode step on the batch and table width.  A paged
    prefill chunk keys on its length and on ``t0``, which the reference
    traces: here ``t0`` sets how many pages the chunk gathers and
    ``flash_attention``'s host ``kv_len``, so it is static.  A failed
    capture or replay raises; nothing falls back to eager.  A miss's host
    time includes its warm-up and capture, as the reference's first jit
    call includes its compile.  On the CPU (the tests) ``"jit"`` runs the
    same fixed-shape body without capture.
  * ``"eager"`` runs the body op by op.

Every other reference strategy (chain, auto, whole_graph, fused,
autotuned) raises ``ValueError`` (ROADMAP Queue A, "CUDA graph / launch
plans").  Both plans run the same bodies (``bodies.py``) on the same device
tensors, so they give the same numbers.

Accounting, per call: the host time around it without a device sync, as
the reference measures its jit dispatch; the launches of the hand-written
kernels (eager: read from the wrappers' counts; jit: recorded at capture
and charged, and credited to the wrappers' counts, on every replay); and
the dispatches.  A jit call is one dispatch, as ``_jit_account`` charges
one.  An eager call's dispatches are its hand-written launches plus the
aten ops it issues that are neither views nor bare allocations, counted
under a ``TorchDispatchMode`` on the first call of each signature.

A graph's output is its own static buffer: it holds the call's logits
until the next call with the same signature, so the caller reads (or
copies) it before then, as the engine does (its host argmax follows each
call).  Each graph owns its memory pool, so no other graph's replay can
overwrite it.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.inference.backends.base import (AccountingMixin,
                                                 BackendInfo, CallAccount)
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.models import make_cache

NOT_PORTED = "not ported yet, see ROADMAP Queue A"
PLANS = ("jit", "eager")
_ALLOCATIONS = ("aten.empty", "aten.empty_strided", "aten.empty_like")


def _host_ints(x, shape) -> np.ndarray:
    """Host int32 copy of ``x`` (numpy, a list or a tensor) in ``shape``."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int32).reshape(shape)


def _views(buf: torch.Tensor, shapes) -> list:
    """``buf`` cut into consecutive tensors of ``shapes``."""
    sizes = [int(np.prod(s)) for s in shapes]
    return [t.view(s) for t, s in zip(buf.split(sizes), shapes)]


class _OpCount(TorchDispatchMode):
    """Counts the aten ops that are neither views nor bare allocations."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and str(func.overloadpacket) not in _ALLOCATIONS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@dataclass
class GraphStats:
    """What the captured graphs cost: how many, the seconds spent warming
    up and capturing them, and the device memory their pools hold."""
    captured: int = 0
    capture_s: float = 0.0
    memory_bytes: int = 0


class _Graph:
    """One captured body: the graph, its static int32 input buffer and the
    pinned staging buffer that refreshes it, its output, and the launches
    of the hand-written kernels one replay runs."""

    def __init__(self, shapes, device):
        n = sum(int(np.prod(s)) for s in shapes)
        self.shapes = shapes
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty(n, dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.out = None
        self.launches: dict = {}

    def load(self, arrays) -> None:
        """Copy this call's inputs into the static buffer (one copy, on
        the current stream, after the last one out of the staging buffer
        has run)."""
        self.copied.synchronize()
        np.concatenate([a.ravel() for a in arrays], out=self.host.numpy())
        self.dev.copy_(self.host, non_blocking=True)
        self.copied.record()

    def inputs(self) -> list:
        return _views(self.dev, self.shapes)


class LocalBackend(AccountingMixin):
    """One device; CUDA graphs (``plan="jit"``) or eager execution."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int,
                 max_len: int, plan: str = "jit", device="cuda"):
        if plan not in PLANS:
            raise ValueError(f"plan {plan!r} {NOT_PORTED}, \"CUDA graph / "
                             f"launch plans\" (the port runs {PLANS})")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"backend device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = max_batch
        self.T = max_len
        self.plan = plan
        self.info = BackendInfo(kind="local", tp=1,
                                devices=(str(self.device),))
        self._init_accounting()
        self._bodies = make_step_bodies(cfg)
        self._capturing = plan == "jit" and self.device.type == "cuda"
        self._graphs: dict = {}       # signature -> _Graph
        self._op_counts: dict = {}    # eager signature -> aten dispatches
        self._stream = None           # the capture stream, made at need
        self._leaves: list = []       # the last cache's leaves, and
        self._leaf_ids: tuple = ()    # their ids and layout key
        self._leaf_key: tuple = ()
        self.graph_stats = GraphStats()

    def init_contiguous_cache(self):
        """Fresh per-slot contiguous KV cache on this device."""
        return make_cache(self.cfg, self.B, self.T, device=self.device)

    def init_paged_cache(self, kv):
        """Fresh pooled KV pages for a ``PagedKVCache`` geometry (built for
        this backend's device)."""
        return kv.make_pages()

    # ------------------------------------------------------------ running
    def _call(self, kind: str, cache, arrays: list, static: tuple):
        """Run body ``kind`` on host int32 ``arrays`` (copied to the device
        as its tensor inputs) and the Python ints ``static``."""
        body = getattr(self._bodies, kind)
        shapes = tuple(a.shape for a in arrays)
        if self._capturing:
            return self._replay(kind, body, cache, arrays, shapes, static)
        key = (kind, shapes, static)
        probe = self.plan == "eager" and key not in self._op_counts
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        with _OpCount() if probe else contextlib.nullcontext() as ops:
            flat = np.concatenate([a.ravel() for a in arrays])
            inputs = _views(torch.from_numpy(flat).to(self.device), shapes)
            out, cache = body(self.params, cache, *inputs, *static)
        host = time.perf_counter() - t0
        after = kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        if probe:
            self._op_counts[key] = ops.n
        dispatches = (1 if self.plan == "jit" else
                      self._op_counts[key] + sum(launches.values()))
        self._charge(CallAccount(dispatches=dispatches, host_time_s=host,
                                 kernel_launches=launches))
        return out, cache

    def _cache_key(self, cache) -> tuple:
        """The address, shape, dtype and strides of every cache leaf.  Read
        again only when the leaves are other tensor objects than last
        call's (held in ``_leaves``, so no new tensor can reuse their
        ids)."""
        ids = tuple(id(t) for layer in cache for t in layer.values())
        if ids != self._leaf_ids:
            self._leaves = [t for layer in cache for t in layer.values()]
            self._leaf_ids = ids
            self._leaf_key = tuple(
                (t.data_ptr(), tuple(t.shape), t.dtype, t.stride())
                for t in self._leaves)
        return self._leaf_key

    def _replay(self, kind, body, cache, arrays, shapes, static):
        t0 = time.perf_counter()
        key = (kind, shapes, static, self._cache_key(cache))
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(kind, body, cache, arrays, shapes, static)
            self._graphs[key] = g
        g.load(arrays)
        g.graph.replay()
        host = time.perf_counter() - t0
        kernels.credit_launches(g.launches)
        self._charge(CallAccount(dispatches=1, host_time_s=host,
                                 kernel_launches=dict(g.launches)))
        return g.out, cache

    def _capture(self, kind, body, cache, arrays, shapes, static) -> _Graph:
        """Warm ``body`` up on the capture stream (which builds the kernels
        and makes the decode split counters and cuBLAS's workspace outside
        the graph's pool), then capture it.  Where the body advances state
        (``StepBodies.advance_state``), the cache is saved before the
        warm-up and restored after, so the replay steps it once."""
        t0 = time.perf_counter()
        dev = self.device
        g = _Graph(shapes, dev)
        g.load(arrays)
        args = (self.params, cache, *g.inputs(), *static)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            saved = ([t.clone() for t in self._leaves]
                     if kind in self._bodies.advance_state else [])
            body(*args)
            for t, s in zip(self._leaves, saved):
                t.copy_(s)
        del saved
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = kernels.launch_counts()
        try:
            with torch.cuda.graph(g.graph, stream=stream):
                g.out, _ = body(*args)
        finally:    # recording a launch is not one: take the counts back
            after = kernels.launch_counts()
            kernels.credit_launches({k: before[k] - after[k] for k in after})
        g.launches = {k: after[k] - before[k] for k in after}
        torch.cuda.empty_cache()
        st = self.graph_stats
        st.memory_bytes += torch.cuda.memory_reserved(dev) - reserved
        st.captured += 1
        st.capture_s += time.perf_counter() - t0
        return g

    # ------------------------------------------------------------ steps
    def prefill(self, cache, tokens, slot: int, plen: int):
        """Write one prompt into a slot; (last-position logits, cache)."""
        toks = _host_ints(tokens, (1, -1))
        return self._call("prefill", cache,
                          [toks, np.array([slot], np.int32)], (int(plen),))

    def decode(self, cache, tokens, lengths):
        """One batched decode step; ``lengths`` (B,) host values."""
        return self._call("decode", cache, [_host_ints(tokens, (-1, 1)),
                                            _host_ints(lengths, (-1,))], ())

    def prefill_chunk(self, cache, tokens, bt_row, t0):
        """Write one prompt chunk into the paged pool through the slot's
        block-table row (host values); (last-position logits, cache)."""
        return self._call("paged_prefill", cache,
                          [_host_ints(tokens, (1, -1)),
                           _host_ints(bt_row, (1, -1))], (int(t0),))

    def paged_decode(self, cache, tokens, lengths, block_tables):
        """One batched decode step over the paged pool; ``lengths`` and
        ``block_tables`` host values."""
        toks = _host_ints(tokens, (-1, 1))
        return self._call("paged_decode", cache,
                          [toks, _host_ints(lengths, (-1,)),
                           _host_ints(block_tables, (toks.shape[0], -1))],
                          ())

    def verify(self, cache, tokens, lengths):
        raise ValueError(f"speculative verify {NOT_PORTED}, \"speculative "
                         "decoding\"")

    def paged_verify(self, cache, tokens, lengths, block_tables):
        raise ValueError(f"speculative verify {NOT_PORTED}, \"speculative "
                         "decoding\"")

    @property
    def planned_decode(self):
        """No launch-plan mode runs here."""
        return None

