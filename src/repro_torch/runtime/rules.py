"""Fusion-rule registry: substitute the hand-written norm kernels into
LaunchPlans.

Counterpart of ``repro/runtime/rules.py``, with its registry, priority and
rule names.  A trace expands the norm ops into their plain versions
(``core.tracing.DECOMPOSITIONS``), as the reference traces plain XLA
norms; a ``RMSNormRule`` matches the contiguous node window one of those
plain versions emits and lowers it to ONE launch of the hand-written
``rmsnorm_matmul`` or ``residual_rmsnorm`` kernel.  ``fused_plan`` overlays
verified matches onto any base ``LaunchPlan``: each window becomes a
single rule-tagged segment, and ``PlanExecutor`` dispatches the fused
kernel instead of replaying the member nodes.

Matching: the rule's window is the plain version itself, traced on small
tensors of the candidate's dtype and rank (``_template``).  A window
matches when its ops are the template's, in order, and its dataflow is the
template's: every argument that is a template node is the corresponding
window node, every template input maps to one value from outside the
window, and every constant agrees, except the sizes of views (which follow
the shapes) and eps (read from the window).  The reference's rules match
f32 only; the port serves bf16 on the card, so its windows hold the
``_to_copy`` nodes of the casts too, and the template, traced in the same
dtype, has them as well.

A window also lies within one operator scope (every node carries the same
``Kernel.operator`` path): a fused kernel stands for one operator's norm.
In f32 the casts vanish and the norm core alone is ambiguous (the
``resid`` add before the next layer's ``norm1``, or the MLP's first
product after ``norm2``, would extend a window across two operators); the
scope keeps each window to the norm site the model wrote.

Safety, as in the reference: a window whose intermediates escape (are used
after it beyond what the fused kernel returns) does not match, and a match
is substituted only after a numeric check: the window's nodes and the
fused kernel run on random inputs of the window's shapes and must agree,
within ``DEFAULT_TOL`` (absolute) in f32 and within ``BF16_TOL`` times
max(1, |result|) in bf16, where both round to bf16 at other points.  On the
card that check runs the hand-written kernel, and a failure there raises
instead of leaving the window unfused (``find_matches``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch.fx import Node
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.tracing import Trace
from repro_torch.kernels.fused.residual_rmsnorm.ops import residual_rmsnorm
from repro_torch.kernels.fused.residual_rmsnorm.ref import residual_rmsnorm_ref
from repro_torch.kernels.fused.rmsnorm_matmul.ops import rmsnorm_matmul
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref
from repro_torch.runtime.plan import LaunchPlan

DEFAULT_TOL = 1e-4
BF16_TOL = 2e-2
# eps the template is traced with, to find the window's own eps
_EPS_MARK = 1.2345e-3
# ops whose constant arguments are sizes that follow the shapes
_SIZE_OPS = ("view", "_unsafe_view", "reshape", "expand")
# the first op of every rule's window: the cast to f32 (bf16), the square
# (f32, no residual) or the residual add (f32)
_FIRST_OPS = ("_to_copy", "pow", "add")


@dataclass
class RuleMatch:
    """One verified occurrence of a rule in a trace."""
    rule_name: str
    start: int
    stop: int                          # exclusive kernel index
    inputs: dict                       # role -> node (or constant)
    provides: dict                     # window node -> fused-result index
    eps: float
    max_abs_err: float = float("nan")  # numeric check result (nan = unchecked)
    failure: Optional[tuple] = None    # (max abs err, tolerance) if it failed

    @property
    def indices(self) -> tuple:
        return tuple(range(self.start, self.stop))


@dataclass
class _Template:
    nodes: list                        # the plain version's op nodes
    roles: dict                        # placeholder node -> role
    outputs: list                      # result index -> template node


_TEMPLATES: dict = {}


def _template(rule: "RMSNormRule", dtype, rank: int) -> _Template:
    """The plain version's node window for inputs of ``dtype`` and
    ``rank`` (cached)."""
    key = (rule.name, dtype, rank)
    tpl = _TEMPLATES.get(key)
    if tpl is not None:
        return tpl
    d = 8
    x = torch.zeros((2,) * (rank - 1) + (d,), dtype=dtype)
    roles = {"x": x, "weight": torch.zeros(d, dtype=dtype)}
    if rule.residual:
        roles["residual"] = torch.zeros_like(x)
    if rule.matmul:
        roles["w_proj"] = torch.zeros((d, 4), dtype=dtype)

    def plain(*vals):
        a = dict(zip(roles, vals))
        if rule.matmul:
            return list(rmsnorm_matmul_ref(a["x"], a["weight"], a["w_proj"],
                                           _EPS_MARK))
        out, total = residual_rmsnorm_ref(a["x"], a["weight"],
                                          a.get("residual"), _EPS_MARK)
        return [out, total] if rule.residual else [out]

    gm = make_fx(plain, tracing_mode="fake")(*roles.values())
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    outs = list(next(n for n in gm.graph.nodes if n.op == "output").args[0])
    tpl = _Template(nodes, dict(zip(phs, roles)), outs)
    _TEMPLATES[key] = tpl
    return tpl


def _bind_args(t, a, mapping, roles, inputs, found, sizes: bool) -> bool:
    """Match one template argument ``t`` against the window's ``a``."""
    if isinstance(t, Node):
        if t in roles:                       # a template input
            if not isinstance(a, Node) or a in mapping.values():
                return False
            seen = inputs.setdefault(roles[t], a)
            return seen is a
        return mapping.get(t) is a
    if isinstance(t, (list, tuple)):
        if sizes and not any(isinstance(v, Node) for v in t):
            return isinstance(a, (list, tuple))
        return (isinstance(a, (list, tuple)) and len(a) == len(t)
                and all(_bind_args(u, b, mapping, roles, inputs, found, sizes)
                        for u, b in zip(t, a)))
    if isinstance(t, float) and t == _EPS_MARK:
        if not isinstance(a, float):
            return False
        found["eps"] = a
        return True
    return sizes or type(t) is type(a) and t == a


@dataclass(frozen=True)
class RMSNormRule:
    """The RMSNorm window family: plain norm, residual+norm, norm+matmul.

    ``residual`` takes in the block-boundary add; ``matmul`` appends the
    projection.  All three lower to the hand-written kernels in
    ``repro_torch.kernels.fused`` (their plain versions on the CPU).
    """
    name: str
    residual: bool = False
    matmul: bool = False

    # ------------------------------------------------------------ bind
    def bind(self, trace: Trace, start: int) -> Optional[RuleMatch]:
        ks = trace.kernels
        first = ks[start].node
        if ks[start].name not in _FIRST_OPS or not first.args:
            return None
        x = first.args[0]
        val = x.meta.get("val") if isinstance(x, Node) else None
        if not isinstance(val, torch.Tensor) or val.dim() < 1:
            return None
        tpl = _template(self, val.dtype, val.dim())
        stop = start + len(tpl.nodes)
        if stop > len(ks):
            return None
        window = ks[start:stop]
        if any(k.node.target is not t.target or k.getitems
               or k.operator != window[0].operator
               for k, t in zip(window, tpl.nodes)):
            return None
        mapping, inputs, found = {}, {}, {}
        for k, t in zip(window, tpl.nodes):
            sizes = k.name in _SIZE_OPS
            if not (_bind_args(t.args, k.node.args, mapping, tpl.roles,
                               inputs, found, sizes)
                    and _bind_args(t.kwargs, k.node.kwargs, mapping,
                                   tpl.roles, inputs, found, sizes)):
                return None
            mapping[t] = k.node
        if "eps" not in found or set(inputs) != set(tpl.roles.values()):
            return None
        provides = {mapping[t]: i for i, t in enumerate(tpl.outputs)
                    if t in mapping}
        # every escaping intermediate must be one the kernel returns
        inside = {k.node for k in window}
        for n in inside:
            if n not in provides and any(u not in inside for u in n.users):
                return None
        return RuleMatch(self.name, start, stop, inputs, provides,
                         eps=found["eps"])

    # ------------------------------------------------------------ lower
    def lower(self, match: RuleMatch):
        """The fused launch of a match: ``fn(env)`` reads the window's
        inputs from ``env`` and sets the nodes it provides."""
        inputs, eps = match.inputs, match.eps
        provides = tuple(match.provides.items())
        residual, matmul = self.residual, self.matmul

        def fused_fn(env):
            a = {role: env[v] if isinstance(v, Node) else v
                 for role, v in inputs.items()}
            if matmul:
                res = rmsnorm_matmul(a["x"], a["weight"], a["w_proj"],
                                     eps=eps)
            else:
                res = residual_rmsnorm(a["x"], a["weight"],
                                       a.get("residual") if residual
                                       else None, eps=eps)
            for node, i in provides:
                env[node] = res[i]

        return fused_fn


# priority order: longest window first, residual before bare norm
REGISTRY = {
    "rmsnorm_matmul": RMSNormRule("rmsnorm_matmul", matmul=True),
    "residual_rmsnorm": RMSNormRule("residual_rmsnorm", residual=True),
    "rmsnorm": RMSNormRule("rmsnorm"),
}
DEFAULT_RULES = tuple(REGISTRY)


def get_rule(name: str):
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown fusion rule {name!r}; "
                       f"registered: {sorted(REGISTRY)}") from None


# per-(rule, window signature) numeric-check cache: binding is structural,
# so one verified signature covers every repetition across layers
_VERIFY_CACHE: dict = {}


def _random_like(val: torch.Tensor, rng) -> torch.Tensor:
    if val.dtype.is_floating_point:
        a = rng.standard_normal(tuple(val.shape))
    else:
        a = np.ones(tuple(val.shape))
    return torch.from_numpy(a.astype(np.float32)).to(val.device, val.dtype)


def _tolerance(ref: torch.Tensor, tol: float) -> float:
    if ref.dtype == torch.bfloat16:
        return BF16_TOL * max(1.0, ref.float().abs().max().item())
    return tol


def verify_match(trace: Trace, match: RuleMatch,
                 tol: float = DEFAULT_TOL) -> float:
    """Numeric equivalence: window replay vs fused kernel on random inputs
    of the window's shapes, dtypes and device.  Returns the max abs error
    over the provided outputs (``inf`` where it exceeds the tolerance, and
    then ``match.failure`` holds the error and the tolerance it broke);
    cached per window signature."""
    window = [trace.kernels[i] for i in match.indices]
    sig = tuple((role, tuple(v.meta["val"].shape), v.meta["val"].dtype,
                 str(v.meta["val"].device))
                for role, v in sorted(match.inputs.items()))
    key = (match.rule_name, match.eps, tol, sig)
    if key not in _VERIFY_CACHE:
        rng = np.random.default_rng(0)
        vals = {v: _random_like(v.meta["val"], rng)
                for v in match.inputs.values()}
        env = dict(vals)
        for k in window:
            k.run(env)
        fused = dict(vals)
        get_rule(match.rule_name).lower(match)(fused)
        err, failure = 0.0, None
        for node in match.provides:
            ref, got = env[node], fused[node]
            e = (ref.double() - got.double()).abs().max().item()
            bound = _tolerance(ref, tol)
            if not e <= bound:                  # NaN fails too
                failure = (e, bound)
                e = float("inf")
            err = max(err, e)
        _VERIFY_CACHE[key] = (err, failure)
    match.max_abs_err, match.failure = _VERIFY_CACHE[key]
    return match.max_abs_err


def _device_of(match: RuleMatch) -> torch.device:
    return next(v.meta["val"].device for v in match.inputs.values()
                if isinstance(v, Node))


def find_matches(trace: Trace, rules: Sequence[str] = DEFAULT_RULES, *,
                 verify: bool = True, tol: float = DEFAULT_TOL) -> list:
    """Non-overlapping rule matches, scanned left to right with the
    registry's priority order at each position.  With ``verify`` (the
    default) every match must pass its numeric-equivalence check.

    A window traced on the CPU that fails the check is left unfused: there
    the fused op is the plain version, so a failure means the window only
    looked like a norm.  On any other device the check runs the
    hand-written kernel, and a failure raises: a wrong kernel must not be
    served around.
    """
    matched: list = []
    pos = 0
    n = len(trace.kernels)
    while pos < n:
        hit = None
        for rn in rules:
            m = get_rule(rn).bind(trace, pos)
            if m is None:
                continue
            if verify and not verify_match(trace, m, tol) < float("inf"):
                device = _device_of(m)
                if device.type != "cpu":
                    err, bound = m.failure
                    raise RuntimeError(
                        f"fusion rule {rn!r} at trace nodes "
                        f"{m.start}:{m.stop} on {device}: the hand-written "
                        f"kernel disagrees with the window it replaces "
                        f"(max abs err {err} > tolerance {bound})")
                continue
            hit = m
            break
        if hit is not None:
            matched.append(hit)
            pos = hit.stop
        else:
            pos += 1
    return matched


def fused_plan(trace: Trace, base: Optional[LaunchPlan] = None,
               rules: Sequence[str] = DEFAULT_RULES, *,
               verify: bool = True, tol: float = DEFAULT_TOL,
               matches: Optional[list] = None) -> LaunchPlan:
    """Overlay rule windows onto ``base`` (default: eager).

    Every matched window becomes one rule-tagged segment; base segments
    are split around the windows, so the result remains an exact
    in-order cover and the plan stays numerically equivalent.
    """
    n = len(trace.kernels)
    if base is None:
        base = LaunchPlan.eager(n)
    if matches is None:
        matches = find_matches(trace, rules, verify=verify, tol=tol)
    window_of = {}
    for m in matches:
        for i in m.indices:
            window_of[i] = m
    segments: list = []
    plan_rules: list = []
    cur: list = []
    for seg in base.segments:
        for i in seg:
            m = window_of.get(i)
            if m is None:
                cur.append(i)
                continue
            if cur:
                segments.append(tuple(cur))
                cur = []
            if i == m.start:
                plan_rules.append((len(segments), m.rule_name))
                segments.append(m.indices)
        if cur:
            segments.append(tuple(cur))
            cur = []
    return LaunchPlan("fused", tuple(segments),
                      rules=tuple(plan_rules)).validate(n)
