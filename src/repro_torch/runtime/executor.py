"""PlanExecutor: run a Trace under a LaunchPlan, directly or as CUDA graphs.

Counterpart of ``repro/runtime/executor.py``.  Each plan segment is ONE
dispatch, the ``cudaLaunchKernel`` analogue the paper counts:

  * ``run`` dispatches every node of a segment in order (eager: one node a
    segment), measuring each segment's host time (``measure_host``);
  * ``capture`` records each segment that launches device work as one
    ``torch.cuda.CUDAGraph``, in plan order and in one memory pool, and
    ``replay`` replays them in the same order.  A segment of views (which
    launches nothing) stays a direct call.  The intermediates a later
    segment reads were allocated during an earlier segment's capture and
    stay where they are, so segment i's replay reads what segment i-1
    wrote; the capture keeps them alive.  A rule segment is one launch of
    the fused kernel, captured as such.  A failed capture raises; nothing
    falls back to direct dispatch.

Built segments live in a process-wide LRU cache keyed by (trace, plan),
so re-planning over the same trace reuses them (``cache_stats`` counts
hits and misses).  A captured program reads its inputs at their addresses
and holds its pool: its owner (the serving backend) keeps it.
"""
from __future__ import annotations

import statistics
import time
import warnings
from collections import OrderedDict
from typing import Optional

import torch
from torch.fx import Node

from repro_torch import kernels
from repro_torch.core.tracing import Trace
from repro_torch.runtime.plan import LaunchPlan
from repro_torch.runtime.rules import get_rule

# (trace.token, plan.key(), input signature) -> _Program
_SEG_CACHE: OrderedDict = OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0}
_CACHE_MAX_ENTRIES = 64


def cache_stats() -> dict:
    return dict(_CACHE_STATS)


def clear_cache() -> None:
    _SEG_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)


class _Segment:
    """One plan segment: its member kernels, or a rule's fused launch."""

    def __init__(self, kernels_, fused=None):
        self.kernels = kernels_
        self.fused = fused
        self.views = fused is None and all(k.is_view for k in kernels_)
        self.graph = None              # its CUDA graph, once captured
        self.launches: dict = {}       # hand-written launches per replay
        self.drops: list = []          # per member: values read last there

    def run(self, env: dict, keep=frozenset()) -> None:
        """Run the members on ``env``, dropping each value after its last
        read (but those in ``keep``), so that memory is reused as in
        eager execution, also inside a captured segment."""
        if self.fused is not None:
            self.fused(env)
            steps = [(None, self.drops[-1] if self.drops else ())]
        else:
            steps = zip(self.kernels, self.drops)
        for k, drop in steps:
            if k is not None:
                k.run(env)
            for n in drop:
                if n not in keep:
                    env.pop(n, None)


class _Program:
    """A plan's segments over one trace, and once captured their graphs
    and the values they hold in place."""

    def __init__(self, trace: Trace, plan: LaunchPlan):
        self.trace = trace
        rule_map = dict(plan.rules)
        self.segments = []
        for si, seg in enumerate(plan.segments):
            members = [trace.kernels[i] for i in seg]
            fused = None
            if si in rule_map:
                rule = get_rule(rule_map[si])
                match = rule.bind(trace, seg[0])
                if match is None or match.indices != tuple(seg):
                    raise ValueError(
                        f"plan tags segment {si} with rule "
                        f"{rule_map[si]!r} but the trace window no "
                        "longer matches")
                fused = rule.lower(match)
            self.segments.append(_Segment(members, fused))
        # after which member each value is last read (outputs: never; a
        # rule segment reads its window's inputs at its last member)
        outs = {a for a in trace.out_args if isinstance(a, Node)}
        last: dict = {}
        for si, s in enumerate(self.segments):
            s.drops = [[] for _ in s.kernels]
            for ki, k in enumerate(s.kernels):
                j = len(s.kernels) - 1 if s.fused is not None else ki
                for n in k.node.all_input_nodes:
                    last[n] = (si, j)
        for n, (si, j) in last.items():
            if n not in outs and n.op == "call_function":
                self.segments[si].drops[j].append(n)
        self.env = None                # the captured program's values
        self.keep = frozenset()        # and those its direct segments read
        self.launches: dict = {}       # hand-written launches per replay

    def run(self, env: dict, host_times: list, measure: bool = False):
        for s in self.segments:
            t0 = time.perf_counter()
            s.run(env)
            if measure and torch.cuda.is_available():
                torch.cuda.synchronize()
            host_times.append(time.perf_counter() - t0)
        return self.trace.outputs(env)

    def capture(self, env: dict, stream, pool) -> None:
        """Capture every segment that launches device work as a CUDA graph
        on ``stream`` into ``pool``, in plan order; ``env`` holds the
        inputs, at the addresses every replay will use."""
        keep = {n for s in self.segments if s.views for k in s.kernels
                for n in k.node.all_input_nodes}  # read again at replay
        with torch.cuda.stream(stream), warnings.catch_warnings():
            # a segment of allocations alone captures an empty graph
            warnings.filterwarnings("ignore", message=".*Graph is empty.*")
            for s in self.segments:
                if s.views:
                    s.run(env, keep)
                else:
                    s.graph, s.launches = _capture(s, env, pool, keep)
        self.env, self.keep = env, keep
        total: dict = {}
        for s in self.segments:
            for k, v in s.launches.items():
                total[k] = total.get(k, 0) + v
        self.launches = total

    def replay(self, host_times: list) -> list:
        env = self.env
        for s in self.segments:
            t0 = time.perf_counter()
            if s.graph is not None:
                s.graph.replay()
            else:
                s.run(env, self.keep)
            host_times.append(time.perf_counter() - t0)
        kernels.credit_launches(self.launches)
        return self.trace.outputs(env)


def _capture(seg: _Segment, env: dict, pool, keep):
    """One segment as a CUDA graph; its hand-written launches are recorded
    and taken back from the wrappers' counts (recording is not
    launching)."""
    g = torch.cuda.CUDAGraph()
    before = kernels.launch_counts()
    g.capture_begin(pool=pool)
    try:
        seg.run(env, keep)
    except BaseException:
        try:
            g.capture_end()
        finally:
            after = kernels.launch_counts()
            kernels.credit_launches({k: before[k] - after[k]
                                     for k in after})
        raise
    g.capture_end()
    after = kernels.launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    kernels.credit_launches({k: -v for k, v in launches.items()})
    return g, launches


class PlanExecutor:
    """Executes a trace segment by segment under a LaunchPlan."""

    def __init__(self, trace: Trace, plan: Optional[LaunchPlan] = None):
        self.trace = trace
        self.plan = plan or LaunchPlan.eager(len(trace.kernels))
        self.plan.validate(len(trace.kernels))
        self._program = None
        self._seg_ops = None

    def segment_operators(self) -> list:
        """Per-segment {canonical op -> member-kernel count} maps."""
        if self._seg_ops is None:
            from repro_torch.telemetry.attribution import segment_ops
            self._seg_ops = [segment_ops(self.trace.kernels, seg)
                             for seg in self.plan.segments]
        return self._seg_ops

    def _lookup(self, key, make) -> _Program:
        prog = _SEG_CACHE.get(key)
        if prog is not None:
            _CACHE_STATS["hits"] += 1
            _SEG_CACHE.move_to_end(key)
            return prog
        _CACHE_STATS["misses"] += 1
        prog = make()
        _SEG_CACHE[key] = prog
        while len(_SEG_CACHE) > _CACHE_MAX_ENTRIES:
            _SEG_CACHE.popitem(last=False)
        return prog

    def _build(self) -> _Program:
        # a trace holds its inputs' shapes: its token is their signature
        key = (self.trace.token, self.plan.key())
        self._program = self._lookup(
            key, lambda: _Program(self.trace, self.plan))
        return self._program

    # ------------------------------------------------------------ execute
    def run_flat(self, flat: list, measure: bool = False):
        """Dispatch every segment on the tensor leaves ``flat``; returns
        (flat outputs, host time per segment)."""
        prog = self._program or self._build()
        host_times: list = []
        outs = prog.run(self.trace.env(flat), host_times, measure)
        return outs, host_times

    def run(self, *args, measure: bool = False):
        """Execute all segments; returns (flat outputs, host time/segment)."""
        return self.run_flat(self.trace.flat_inputs(*args), measure)

    def call(self, *args):
        """Like run(), with the outputs in the traced function's form."""
        return self.call_timed(*args)[0]

    def call_timed(self, *args):
        outputs, host_times = self.run(*args)
        return self.trace.unflatten(outputs), host_times

    def capture(self, flat: list, stream, pool=None) -> _Program:
        """The plan captured as CUDA graphs over the tensor leaves ``flat``,
        which every replay of the returned program reads and writes in
        place.  The caller keeps the program: it holds those tensors and
        its graphs' pool, so no process-wide cache may."""
        prog = _Program(self.trace, self.plan)
        prog.capture(self.trace.env(flat), stream,
                     pool if pool is not None
                     else torch.cuda.graph_pool_handle())
        return prog

    def measure_host(self, *args, repeats: int = 3):
        """Warm up, then measure the median per-segment dispatch time."""
        self.run(*args)
        all_times = []
        for _ in range(repeats):
            _, ts = self.run(*args)
            all_times.append(ts)
        med = [statistics.median(x) for x in zip(*all_times)]
        if self.plan.n_launches == len(self.trace.kernels):
            for k, t in zip(self.trace.kernels, med):
                k.host_dispatch_s = t
        return med

    @property
    def n_launches(self) -> int:
        return self.plan.n_launches
