"""SKIP tracing on the aten op stream: an FX graph of one step, one node per
kernel launch, with modeled costs and operator provenance.

Counterpart of ``repro/core/tracing.py``.  The reference flattens a jaxpr;
here ``make_fx`` traces the step in fake mode into an FX graph of aten ops
with exact dataflow, as the jaxpr has it:

  ATen operator stream       -> the trace's call_function nodes
  one eager dispatch         -> one node (``Kernel``)
  CUDA graph of the step     -> plan ``whole_graph`` (one dispatch)
  fused chains (this work)   -> one CUDA graph per segment

Each of the port's hand-written kernels is a ``torch.library`` custom op
(``kernels/*/ops.py``), so its launch is one node, and an in-place write
into a cache argument is recorded on that argument's placeholder: running
the graph writes the caller's tensor, tracing leaves it untouched.  The
three norm ops (``residual_rmsnorm``, ``rmsnorm_matmul`` and the legacy
``rmsnorm``) are expanded into their plain versions (``DECOMPOSITIONS``),
as the reference traces plain XLA norms: the fused plan's rules
(``runtime/rules.py``) find those windows and lower them to the
hand-written kernels again.  The attention kernels and ``wkv6`` stay one
node each.  The graph is not functionalized: a cache write stays one
in-place op, not a copy of the cache.

Provenance: the model's ``torch.profiler.record_function`` scopes are
recorded as ``profiler._record_function_enter_new`` / ``_exit`` nodes; the
tracer turns them into each kernel's ``operator`` path (``layer0/attn``)
and drops them from the kernel list, so they are never counted or run.
"""
from __future__ import annotations

import itertools
import operator
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.fx import Node
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.node import map_arg
from torch.utils import _pytree as pytree

from repro_torch.core.costs import op_costs
from repro_torch.kernels import WRAPPERS
from repro_torch.kernels.fused.residual_rmsnorm.ref import residual_rmsnorm_ref
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref

_TRACE_TOKENS = itertools.count()

# custom op -> wrapper name, for the hand-written kernels
HAND_WRITTEN = {fn.op: name for name, fn in WRAPPERS.items()}


def _norm_plain(x, weight, residual, eps):
    out, total = residual_rmsnorm_ref(x, weight, residual, eps)
    return [out] if residual is None else [out, total]


def _norm_matmul_plain(x, weight, w_proj, eps):
    return rmsnorm_matmul_ref(x, weight, w_proj, eps)


# the norm ops a trace expands into their plain versions (``ref.py``)
DECOMPOSITIONS = {WRAPPERS["residual_rmsnorm"].op: _norm_plain,
                  WRAPPERS["rmsnorm"].op: _norm_plain,
                  WRAPPERS["rmsnorm_matmul"].op: _norm_matmul_plain}


def op_name(target) -> str:
    """A node's kernel name: the op's name without namespace or overload
    (``mm``, ``_to_copy``, ``decode_attention``)."""
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else str(target)


def _is_marker(target) -> bool:
    return getattr(target, "namespace", "") == "profiler"


def _meta(a):
    return a.meta.get("val") if isinstance(a, Node) else a


@dataclass
class Kernel:
    """One aten op (or hand-written kernel) node = one eager dispatch."""
    index: int
    name: str                       # op name
    node: Node
    flops: float
    bytes: float
    out_shapes: tuple
    host_dispatch_s: float = 0.0    # measured on this host
    operator: str = ""              # enclosing scope path
    getitems: tuple = ()            # nodes unpacking a tuple result

    @property
    def is_view(self) -> bool:
        """Launches no device work: a view of its input (or a bare
        reinterpretation of it)."""
        t = self.node.target
        return bool(getattr(t, "is_view", False)) or op_name(t) in (
            "_unsafe_view", "alias")

    def run(self, env: dict) -> None:
        """Dispatch this node on the values in ``env`` and record its
        result (and the items of a tuple result)."""
        n = self.node
        val = n.target(*map_arg(n.args, env.__getitem__),
                       **map_arg(n.kwargs, env.__getitem__))
        env[n] = val
        if self.getitems:
            for g in self.getitems:
                env[g] = env[g.args[0]][g.args[1]]
            del env[n]              # later nodes read the items


@dataclass
class Trace:
    graph_module: object            # torch.fx.GraphModule
    placeholders: list              # one per tensor leaf of the inputs
    kernels: list                   # list[Kernel], in program order
    example_args: tuple
    in_spec: object                 # pytree spec of the inputs
    tensor_slots: tuple             # leaf indices that are tensors
    out_args: list                  # flat outputs: nodes or constants
    out_spec: object = None         # pytree spec of the outputs
    constants: dict = field(default_factory=dict)   # get_attr node -> value
    token: int = -1                 # unique id (segment cache key)
    seconds: float = 0.0            # time taken to trace

    @property
    def kernel_names(self) -> list[str]:
        return [k.name for k in self.kernels]

    def total_flops(self) -> float:
        return sum(k.flops for k in self.kernels)

    def flat_inputs(self, *args) -> list:
        """The tensor leaves of ``args``, in placeholder order."""
        leaves = pytree.tree_leaves(args)
        return [leaves[i] for i in self.tensor_slots]

    def env(self, flat: list) -> dict:
        """Node -> value for the placeholders (``flat``) and constants."""
        env = dict(zip(self.placeholders, flat))
        env.update(self.constants)
        return env

    def outputs(self, env: dict) -> list:
        return [env[a] if isinstance(a, Node) else a for a in self.out_args]

    def unflatten(self, outs: list):
        return (pytree.tree_unflatten(outs, self.out_spec)
                if self.out_spec is not None else outs)


def _costs(node: Node, name: str) -> tuple[float, float]:
    args = map_arg(node.args, _meta)
    kwargs = map_arg(node.kwargs, _meta)
    hand = HAND_WRITTEN.get(node.target)
    if hand is not None:
        return WRAPPERS[hand].costs(*args, **kwargs)
    return op_costs(name, args, kwargs, node.meta.get("val"))


def _shapes(val) -> tuple:
    if isinstance(val, torch.Tensor):
        return (tuple(val.shape),)
    if isinstance(val, (list, tuple)):
        return tuple(s for v in val for s in _shapes(v))
    return ()


def trace_fn(fn: Callable, *example_args,
             decompositions: Optional[dict] = None) -> Trace:
    """Trace ``fn(*example_args)`` into a kernel trace with cost estimates.

    ``example_args`` may be nested lists and dicts of tensors (the params,
    the cache); their tensor leaves become the graph's placeholders and
    other leaves stay constants.  Nothing of the arguments is changed.
    """
    t0 = time.perf_counter()
    leaves, in_spec = pytree.tree_flatten(example_args)
    slots = tuple(i for i, v in enumerate(leaves)
                  if isinstance(v, torch.Tensor))
    box = {}

    def flat_fn(*tensors):
        vals = list(leaves)
        for i, t in zip(slots, tensors):
            vals[i] = t
        out = fn(*pytree.tree_unflatten(vals, in_spec))
        flat, box["spec"] = pytree.tree_flatten(out)
        return flat

    gm = make_fx(flat_fn, tracing_mode="fake",
                 decomposition_table=(DECOMPOSITIONS if decompositions is None
                                      else decompositions))(
        *[leaves[i] for i in slots])
    placeholders, kernels, constants = [], [], {}
    stack: list = []                # [(enter node, scope name)]
    owner: dict = {}                # tuple-valued node -> its Kernel
    out_args: list = []
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            placeholders.append(n)
        elif n.op == "get_attr":
            constants[n] = getattr(gm, n.target)
        elif n.op == "output":
            out_args = list(n.args[0])
        elif n.target is operator.getitem:
            k = owner[n.args[0]]
            k.getitems += (n,)
            owner[n] = k
        elif _is_marker(n.target):
            if "enter" in str(n.target):
                stack.append((n, n.args[0]))
            else:
                stack = [s for s in stack if s[0] is not n.args[0]]
        else:
            name = op_name(n.target)
            fl, bt = _costs(n, name)
            k = Kernel(len(kernels), name, n, fl, bt,
                       _shapes(n.meta.get("val")),
                       operator="/".join(s for _, s in stack))
            kernels.append(k)
            owner[n] = k
    return Trace(graph_module=gm, placeholders=placeholders,
                 kernels=kernels, example_args=example_args,
                 in_spec=in_spec, tensor_slots=slots, out_args=out_args,
                 out_spec=box.get("spec"), constants=constants,
                 token=next(_TRACE_TOKENS),
                 seconds=time.perf_counter() - t0)


class Executor:
    """Back-compat facade over ``repro_torch.runtime.PlanExecutor``.

    ``Executor(trace)`` is the eager plan (one dispatch per node);
    ``Executor(trace, segments=...)`` wraps an explicit segment list.
    """

    def __init__(self, trace: Trace, segments: Optional[list] = None):
        from repro_torch.runtime.executor import PlanExecutor
        from repro_torch.runtime.plan import LaunchPlan
        plan = (LaunchPlan.from_segments(segments) if segments is not None
                else LaunchPlan.eager(len(trace.kernels)))
        self.trace = trace
        self._ex = PlanExecutor(trace, plan)

    @property
    def plan(self):
        return self._ex.plan

    @property
    def segments(self) -> list:
        return [list(s) for s in self._ex.plan.segments]

    def run(self, *args, measure: bool = False):
        return self._ex.run(*args, measure=measure)

    def measure_host(self, *args, repeats: int = 3):
        return self._ex.measure_host(*args, repeats=repeats)

    @property
    def n_launches(self) -> int:
        return self._ex.n_launches
