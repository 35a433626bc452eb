"""Single-device execution backend: the step bodies as CUDA graphs, or
through the launch-plan runtime.

Counterpart of ``repro/inference/backends/local.py`` for the contiguous
and the paged cache, with the speculative verify of both and the draft
model's step (``backends.speculative`` serves the draft through a
``LocalBackend`` of its own).  Plans:

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
    reference keeps static, but for the prompt length: a contiguous
    prefill keys on its bucket (the slot and ``plen`` are device inputs),
    an RWKV or encoder prefill on its exact prompt length, a decode step
    on the batch and table width, a verify on (B, k+1) and the table width
    (``pick_spec_k`` takes at most two k, so two verify graphs a cache), a
    draft step on its width (2 for the catch-up step, then 1).  A paged prefill chunk keys on its
    length and on ``t0``, which the reference traces: here ``t0`` sets
    how many pages the chunk gathers and ``flash_attention``'s host
    ``kv_len``, so it is static.  A failed capture or replay raises;
    nothing falls back to eager.  A miss's host time includes its warm-up
    and capture, as the reference's first jit call includes its compile.  On the CPU (the tests) ``"jit"`` runs the
    same fixed-shape body without capture.
  * ``"eager"``, ``"whole_graph"``, ``"chain"``, ``"auto"`` and
    ``"fused"`` route through the launch-plan runtime, as the reference's
    ``_PlannedFn`` does: on its first call with a signature (the jit key
    without addresses) the body is traced (``core.tracing.trace_fn``, the
    norms expanded into their plain versions), a ``LaunchPlan`` is chosen
    for the strategy and priced on the ``platform`` row
    (``runtime.Planner``: modeled TKLQT and its attribution to operators),
    and every call runs the plan (a signature is traced once per process
    and its trace shared by every engine).  ``"eager"`` dispatches one
    node at a time; the others, on a CUDA device, capture the plan's
    segments once per signature with addresses (warm-up and state restore
    as under jit, the inputs staged by the same pinned copy) and replay
    them, one dispatch a segment; on the CPU they run each segment's
    nodes directly.  Under ``"fused"`` the rule windows launch the hand-written
    ``rmsnorm_matmul`` and ``residual_rmsnorm`` kernels; under the other
    planned strategies the norms run as their plain versions.

``"autotuned"`` is not a backend plan: the engine resolves its plan
table to one of these before it builds the backend, as the reference
does.  Every plan runs the same bodies (``bodies.py``) on the same device
tensors.

Accounting, per call: the host time around it without a device sync, as
the reference measures its jit dispatch; the launches of the hand-written
kernels (direct runs: read from the wrappers' counts; graphs: recorded at
capture and charged, and credited to the wrappers' counts, on every
replay); and the dispatches: 1 for a jit call, the plan's segments for a
planned one, beside its modeled TKLQT, the fused rules that fired, the
per-segment host times and the attribution.

A graph's output is its own static buffer: it holds the call's logits
until the next call with the same signature, so the caller reads (or
copies) it before then, as the engine does (its host argmax follows each
call).  Each jit graph owns its memory pool, so no other graph's replay
can overwrite it; a plan's segments share one pool of their own.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tracing import trace_fn
from repro_torch.device import resolve_device
from repro_torch.inference.backends.base import (AccountingMixin,
                                                 BackendInfo, CallAccount)
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.models import make_cache
from repro_torch.runtime import (LaunchPlan, PlanExecutor, Planner,
                                 simulate_plan)
from repro_torch.runtime.plan import segment_label
from repro_torch.telemetry.attribution import attribute_events

# process-wide traces of the planned bodies, by signature (the trace of a
# signature is the same for every engine; its plan is the engine's own)
_TRACES: OrderedDict = OrderedDict()
_TRACES_MAX = 64
PLANS = ("jit", "eager", "whole_graph", "chain", "auto", "fused")


def _host_ints(x, shape) -> np.ndarray:
    """Host int32 copy of ``x`` (numpy, a list or a tensor) in ``shape``."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int32).reshape(shape)


def _views(buf: torch.Tensor, shapes) -> list:
    """``buf`` cut into consecutive tensors of ``shapes``."""
    sizes = [int(np.prod(s)) for s in shapes]
    return [t.view(s) for t, s in zip(buf.split(sizes), shapes)]


@dataclass
class GraphStats:
    """What the captured graphs cost: how many, the seconds spent warming
    up and capturing them, the device memory their pools hold, and how
    many times they were replayed."""
    captured: int = 0
    capture_s: float = 0.0
    memory_bytes: int = 0
    replays: int = 0


@dataclass
class TraceStats:
    """What tracing the planned bodies cost: traces, their nodes (kernels),
    and the seconds spent tracing and planning."""
    traces: int = 0
    kernels: int = 0
    seconds: float = 0.0


class _Staging:
    """A static int32 input buffer on the device and the pinned staging
    buffer that refreshes it: the inputs of a captured graph (or plan)."""

    def __init__(self, shapes, device):
        n = sum(int(np.prod(s)) for s in shapes)
        self.shapes = shapes
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty(n, dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event()

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


class _Graph(_Staging):
    """One captured body: its staged inputs, its graph segments (one, or
    one more than the reduce sites it was cut at), the partial each cut
    leaves to be reduced between two replays and a pinned host buffer for
    it, its output, and the launches of the hand-written kernels one
    replay runs."""

    def __init__(self, shapes, device):
        super().__init__(shapes, device)
        self.graphs: list = []
        self.bufs: list = []
        self.hosts: list = []
        self.out = None
        self.launches: dict = {}


class _Cutter:
    """A capture in progress, cut into a new segment at each reduce site
    (a body without a reduce hook is never cut: one segment); every
    segment goes into one memory pool and is replayed in capture order."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []
        self.bufs: list = []
        self._g = None

    def begin(self) -> None:
        self._g = torch.cuda.CUDAGraph()
        self._g.capture_begin(pool=self.pool)

    def end(self) -> None:
        self._g.capture_end()
        self.graphs.append(self._g)
        self._g = None

    def cut(self, x: torch.Tensor) -> None:
        self.end()
        self.bufs.append(x)
        self.begin()

    def abort(self) -> None:
        if self._g is not None:
            g, self._g = self._g, None
            try:
                g.capture_end()
            except RuntimeError:
                pass


class _PlannedFn:
    """One body signature routed through the launch-plan runtime.

    Traced and planned on its first call (shapes are only known then);
    afterwards every call runs the chosen plan (``LocalBackend._planned``).
    """

    def __init__(self, strategy: str, platform: str,
                 lengths=(2, 4, 8, 16, 32)):
        self.strategy = strategy
        self.platform = platform
        self.lengths = lengths
        self.trace = None
        self.executor = None
        self.plan = None                # chosen LaunchPlan (after build)
        self.modeled_tklqt_s = 0.0      # modeled TKLQT of ONE invocation
        self.modeled_events = []        # simulated device timeline, one call
        self.last_host_times = []       # measured per-segment dispatch
        self.segment_names = []
        self.segment_ops = ()           # per-segment {op -> kernel count}
        self.attribution = None         # AttributionReport, one invocation
        self.trace_s = 0.0              # seconds to plan (and trace)

    def build(self, trace) -> None:
        """Choose the LaunchPlan for this strategy over ``trace``, and
        price it."""
        t0 = time.perf_counter()
        planner = Planner(trace, self.platform)
        n = len(trace.kernels)
        if self.strategy == "eager":
            plan = LaunchPlan.eager(n)
        elif self.strategy == "whole_graph":
            plan = LaunchPlan.whole_graph(n)
        elif self.strategy == "chain":
            plan = planner.compare(
                [planner.chain(L) for L in self.lengths])[0].plan
        elif self.strategy == "auto":
            plan = planner.auto(lengths=self.lengths).plan
        elif self.strategy == "fused":
            plan = planner.fused_rules(lengths=self.lengths)
        else:
            raise ValueError(f"unknown plan strategy {self.strategy!r}")
        self.trace, self.plan = trace, plan
        self.executor = PlanExecutor(trace, plan)
        self.modeled_tklqt_s = planner.evaluate(plan).tklqt
        self.modeled_events = simulate_plan(trace.kernels, plan, planner.spec)
        self.segment_names = [segment_label(trace.kernels, s)
                              for s in plan.segments]
        # operator->kernel attribution of ONE call, constant afterwards
        self.segment_ops = tuple(self.executor.segment_operators())
        self.attribution = attribute_events(trace.kernels, plan,
                                            self.modeled_events)
        self.trace_s += time.perf_counter() - t0

    @property
    def n_launches(self) -> int:
        """Host dispatches per invocation (0 before the first build)."""
        return self.executor.n_launches if self.executor else 0

    @property
    def rule_names(self) -> list:
        """Fusion-rule names overlaid on the chosen plan."""
        return self.plan.rule_names() if self.plan is not None else []


class StepCalls:
    """The step kinds of the backend protocol, each turning its host
    values into fixed-shape int32 arrays for ``self._call(kind, cache,
    arrays, static)``: shared by ``LocalBackend`` and the tensor-parallel
    ``backends.sharded.ShardedBackend``."""

    def prefill(self, cache, tokens, slot: int, plen: int):
        """Write one prompt into a slot; (last-position logits, cache)."""
        toks = _host_ints(tokens, (1, -1))
        return self._call("prefill", cache,
                          [toks, np.array([slot], np.int32),
                           np.array([plen], np.int32)], ())

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
        """Score k+1 tokens a row in one batched step (the speculative
        verify); tokens (B, k+1), ``lengths`` (B,) host values; (every
        logits row (B, k+1, V), cache).  Under jit one graph per (B, k+1)."""
        toks = _host_ints(tokens, (self.B, -1))
        return self._call("verify", cache,
                          [toks, _host_ints(lengths, (-1,))], ())

    def paged_verify(self, cache, tokens, lengths, block_tables):
        """``verify`` over the paged pool."""
        toks = _host_ints(tokens, (self.B, -1))
        return self._call("paged_verify", cache,
                          [toks, _host_ints(lengths, (-1,)),
                           _host_ints(block_tables, (self.B, -1))], ())

    def draft_step(self, cache, tokens, positions, lengths):
        """One step of the speculative draft model (this backend serving
        the draft): tokens and positions (B, W) right-aligned, ``lengths``
        (B,); (last-column logits (B, V), cache)."""
        toks = _host_ints(tokens, (self.B, -1))
        return self._call("draft_step", cache,
                          [toks, _host_ints(positions, toks.shape),
                           _host_ints(lengths, (-1,))], ())


class LocalBackend(StepCalls, AccountingMixin):
    """One device; CUDA graphs (``plan="jit"``) or a launch plan."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int,
                 max_len: int, plan: str = "jit", device="cuda",
                 platform: str = "Intel+H100"):
        if plan not in PLANS:
            raise ValueError(f"unknown plan {plan!r}; expected one of "
                             f"{PLANS}")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"backend device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = max_batch
        self.T = max_len
        self.plan = plan
        self.platform = platform
        self.info = BackendInfo(kind="local", tp=1,
                                devices=(str(self.device),))
        self._init_accounting()
        self._bodies = make_step_bodies(cfg)
        cuda = self.device.type == "cuda"
        self._capturing = plan == "jit" and cuda
        self._captured_plan = plan not in ("jit", "eager") and cuda
        self._graphs: dict = {}       # signature -> _Graph
        self._cuts = None             # the _Cutter of a capture under way
        self._planned_fns: dict = {}  # signature without addresses ->
        self._programs: dict = {}     # _PlannedFn; with them -> (staging,
        self._planned_decode = None   # captured program)
        self._param_leaves = pytree.tree_leaves(params)
        self._stream = None           # the capture stream, made at need
        self._leaves: list = []       # the last cache's leaves, and
        self._leaf_ids: tuple = ()    # their ids and layout key
        self._leaf_key: tuple = ()
        self.graph_stats = GraphStats()
        self.trace_stats = TraceStats()

    def init_contiguous_cache(self):
        """Fresh per-slot contiguous KV cache on this device.  A cross
        layer's cache holds one zero row (``src_len=1``), as the
        reference's: no served body passes encoder or image inputs, so
        served cross-attention attends over that row."""
        return make_cache(self.cfg, self.B, self.T, src_len=1,
                          device=self.device)

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
        if self.plan != "jit":
            return self._planned(kind, body, cache, arrays, shapes, static)
        if self._capturing:
            return self._replay(kind, body, cache, arrays, shapes, static)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        out, cache = body(self.params, cache,
                          *self._device_inputs(arrays, shapes), *static)
        host = time.perf_counter() - t0
        after = kernels.launch_counts()
        self._charge(CallAccount(dispatches=1, host_time_s=host,
                                 kernel_launches={k: after[k] - before[k]
                                                  for k in after}))
        return out, cache

    def _device_inputs(self, arrays, shapes) -> list:
        flat = np.concatenate([a.ravel() for a in arrays])
        return _views(torch.from_numpy(flat).to(self.device), shapes)

    def _planned(self, kind, body, cache, arrays, shapes, static):
        """One call under a launch plan: traced and planned on the first
        call of its signature, then run (eager, or on the CPU) or captured
        once per cache address and replayed."""
        t0 = time.perf_counter()
        layout = self._cache_key(cache)
        key = (kind, shapes, static, tuple(k[1:] for k in layout))
        pf = self._planned_fns.get(key)
        host_times: list = []
        if self._captured_plan:
            hit = self._programs.get((key, layout))
            if hit is None:
                hit = self._capture_plan(key, kind, body, cache, arrays,
                                         shapes, static, pf)
                pf = self._planned_fns[key]
                self._programs[(key, layout)] = hit
            staging, prog = hit
            staging.load(arrays)
            outs = pf.executor.replay(prog, host_times)
            launches = dict(prog.launches)
        else:
            inputs = self._device_inputs(arrays, shapes)
            if pf is None:
                pf = self._plan_body(key, kind, body, cache, inputs, static)
            before = kernels.launch_counts()
            outs, host_times = pf.executor.run_flat(
                self._param_leaves + self._leaves + inputs)
            after = kernels.launch_counts()
            launches = {k: after[k] - before[k] for k in after}
        host = time.perf_counter() - t0
        pf.last_host_times = host_times
        if kind in ("decode", "paged_decode"):
            self._planned_decode = pf
        self._charge(CallAccount(
            dispatches=pf.n_launches, host_time_s=host,
            modeled_tklqt_s=pf.modeled_tklqt_s,
            rule_names=tuple(pf.rule_names),
            segment_names=tuple(pf.segment_names),
            segment_host_times=tuple(host_times),
            segment_ops=pf.segment_ops, attribution=pf.attribution,
            kernel_launches=launches))
        return pf.trace.unflatten(outs), cache

    def _plan_body(self, key, kind, body, cache, inputs, static):
        """Plan ``body`` for one signature over its trace, traced on the
        first call of the signature in this process (the trace returns the
        logits only: the cache is written in place)."""
        pf = _PlannedFn(self.plan, self.platform)
        tkey = (self.cfg, str(self.device), key,
                tuple((tuple(t.shape), t.dtype, t.stride())
                      for t in self._param_leaves))
        trace = _TRACES.get(tkey)
        if trace is None:
            trace = trace_fn(lambda p, c, *a: body(p, c, *a, *static)[0],
                             self.params, cache, *inputs)
            if len(trace.placeholders) != (len(self._param_leaves)
                                           + len(self._leaves)
                                           + len(inputs)):
                raise ValueError("the params and the cache must hold "
                                 "tensors only to be traced")
            trace.example_args = ()   # hold no engine's tensors
            pf.trace_s = trace.seconds
            _TRACES[tkey] = trace
            while len(_TRACES) > _TRACES_MAX:
                _TRACES.popitem(last=False)
            st = self.trace_stats
            st.traces += 1
            st.kernels += len(trace.kernels)
        pf.build(trace)
        self.trace_stats.seconds += pf.trace_s
        self._planned_fns[key] = pf
        return pf

    def _capture_plan(self, key, kind, body, cache, arrays, shapes, static,
                      pf):
        """Trace and plan the body (once per signature), warm its plan up
        on the capture stream (the state restored where the body advances
        it, as under jit), then capture its segments into one pool."""
        t0 = time.perf_counter()
        dev = self.device
        staging = _Staging(shapes, dev)
        staging.load(arrays)
        inputs = staging.inputs()
        if pf is None:
            pf = self._plan_body(key, kind, body, cache, inputs, static)
        flat = self._param_leaves + self._leaves + inputs
        stream = self._capture_stream()
        with torch.cuda.stream(stream):
            saved = ([t.clone() for t in self._leaves]
                     if kind in self._bodies.advance_state else [])
            pf.executor.run_flat(flat)
            for t, s in zip(self._leaves, saved):
                t.copy_(s)
        del saved
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        prog = pf.executor.capture(flat, stream)
        torch.cuda.synchronize(dev)
        st = self.graph_stats
        st.memory_bytes += torch.cuda.memory_reserved(dev) - reserved
        st.captured += sum(s.graph is not None for s in prog.segments)
        st.capture_s += time.perf_counter() - t0
        return staging, prog

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return self._stream

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
        for i, graph in enumerate(g.graphs):
            if i:
                self._reduce_replayed(g.bufs[i - 1], g.hosts[i - 1])
            graph.replay()
        self.graph_stats.replays += len(g.graphs)
        host = time.perf_counter() - t0
        kernels.credit_launches(g.launches)
        self._charge(CallAccount(dispatches=1, host_time_s=host,
                                 kernel_launches=dict(g.launches)))
        return g.out, cache

    def _reduce_replayed(self, buf: torch.Tensor,
                         host: torch.Tensor) -> None:
        """Reduce the partial ``buf`` that a cut left between two segment
        replays.  Only a body with a reduce hook is cut, and a single
        device's bodies have none."""
        raise NotImplementedError("a single-device body has no reduce")

    def _capture(self, kind, body, cache, arrays, shapes, static) -> _Graph:
        """Warm ``body`` up on the capture stream (which builds the kernels
        and makes the decode split counters and cuBLAS's workspace outside
        the graph's pool), then capture it, a new segment at each reduce
        site the body's hook cuts at (``_cuts``).  Where the body advances
        state (``StepBodies.advance_state``), the cache is saved before the
        warm-up and restored after, so the replay steps it once."""
        t0 = time.perf_counter()
        dev = self.device
        g = _Graph(shapes, dev)
        g.load(arrays)
        args = (self.params, cache, *g.inputs(), *static)
        stream = self._capture_stream()
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
        cuts = self._cuts = _Cutter()
        try:
            with torch.cuda.stream(stream):
                cuts.begin()
                g.out, _ = body(*args)
                cuts.end()
        except BaseException:
            cuts.abort()
            raise
        finally:    # recording a launch is not one: take the counts back
            self._cuts = None
            after = kernels.launch_counts()
            kernels.credit_launches({k: before[k] - after[k] for k in after})
        g.launches = {k: after[k] - before[k] for k in after}
        g.graphs, g.bufs = cuts.graphs, cuts.bufs
        g.hosts = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                   for b in g.bufs]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        st = self.graph_stats
        st.memory_bytes += torch.cuda.memory_reserved(dev) - reserved
        st.captured += len(g.graphs)
        st.capture_s += time.perf_counter() - t0
        return g

    def reset_cache(self, cache) -> None:
        """Zero every leaf of ``cache`` in place (the engine's reset), so
        the graphs keyed on its addresses replay."""
        for layer in cache:
            for t in layer.values():
                t.zero_()

    def close(self) -> None:
        """Nothing to release: one device, no other process."""

    @property
    def planned_decode(self):
        """The decode ``_PlannedFn`` last run in a launch-plan mode (None
        under jit and before the first decode step)."""
        return self._planned_decode

