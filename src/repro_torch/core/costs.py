"""Per-aten-op FLOP/byte cost model for traced kernels.

Counterpart of ``repro/core/costs.py`` over the aten op stream: the
reference's rules, one aten op for one jaxpr primitive.  Used by the
device model to derive modeled kernel durations on each platform
(per-kernel roofline: max(flops/peak, bytes/bw) + fixed overhead).

  * ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm``: 2 · output elements · K
    (``dot_general``'s rule);
  * transcendental ops: 4 · output elements;
  * reductions: the input's elements;
  * everything else: the output's elements;
  * bytes: every tensor input plus every tensor output.

A node of one of the port's hand-written kernels (``repro_torch::*``)
takes its FLOPs and bytes from its wrapper's ``costs``: what the kernel
moves and computes, the numbers its roofline bound divides.
"""
from __future__ import annotations

import math

import torch

TRANSCENDENTAL = {"exp", "tanh", "log", "sigmoid", "erf", "rsqrt", "sqrt",
                  "sin", "cos", "pow", "cumsum", "logcumsumexp", "silu",
                  "gelu", "softplus", "exp2", "log1p", "expm1"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
              "argmin", "sort", "topk", "var", "std", "var_mean", "logsumexp",
              "_softmax", "_log_softmax", "all", "any", "norm",
              "linalg_vector_norm"}
PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _numel(t) -> int:
    return math.prod(t.shape) if t.dim() else 1


def _bytes(t) -> int:
    return _numel(t) * t.element_size()


def op_costs(name: str, args, kwargs, out) -> tuple[float, float]:
    """(flops, bytes) of one aten op ``name`` (its packet name, e.g.
    ``"mm"``) on ``args``/``kwargs`` with result ``out`` (fake or real
    tensors)."""
    ins = _tensors(args) + _tensors(kwargs)
    outs = _tensors(out)
    bts = float(sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs))
    out_elems = sum(_numel(t) for t in outs)
    if name in PRODUCTS:
        # the contracted size is the last dim of the left operand (the
        # first tensor argument after addmm's / baddbmm's bias)
        lhs = ins[1] if name in ("addmm", "baddbmm") else ins[0]
        return 2.0 * out_elems * lhs.shape[-1], bts
    if name in TRANSCENDENTAL:
        return 4.0 * out_elems, bts
    if name in REDUCTIONS:
        return float(sum(_numel(t) for t in ins[:1])), bts
    return float(out_elems), bts
