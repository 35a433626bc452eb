"""Rank bodies and helpers shared by the multi-rank port tests.

The bodies run inside rank processes (``repro_torch.distributed.ranks``),
which import them by reference, so they live in this module, which
imports torch and the port only.  ``reference(code, devices)`` starts the
reference's side in a subprocess with that many forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``); its last line of
output is JSON.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

from repro_torch.distributed.compression import (_quantize, compressed_psum,
                                                 init_error_state,
                                                 make_compressed_dp_grad)
from repro_torch.distributed.pipeline import pipeline_forward
from repro_torch.layers.moe import moe_ep_fwd
from repro_torch.models import forward, loss_fn, stage_forward

ROOT = Path(__file__).resolve().parents[1]


class Reference:
    """The reference's side, started at once and read when needed."""

    def __init__(self, code: str, devices: int):
        env = {"XLA_FLAGS":
               f"--xla_force_host_platform_device_count={devices}",
               "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
               "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(ROOT))
        self._out = None

    def result(self):
        if self._out is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err[-3000:]
            self._out = json.loads(out.strip().splitlines()[-1])
        return self._out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


# ------------------------------------------------------------ compression
def compression_body(ctx, grads, errors):
    """Each leaf's payload and scale, then two steps of error feedback."""
    qs = {k: _quantize(g, errors[k])[:2] for k, g in grads.items()}
    mean, err = compressed_psum(grads, errors, ctx, "data")
    mean2, err2 = compressed_psum(grads, err, ctx, "data")
    return {"q": {k: q for k, (q, _) in qs.items()},
            "scale": {k: s for k, (_, s) in qs.items()},
            "mean": mean, "err": err, "mean2": mean2, "err2": err2}


def quad_loss(p, b):
    """The reference test's loss: mean((b @ w) ** 2)."""
    return ((b @ p["w"]) ** 2).mean(), 0.0


def dp_grad_body(ctx, w, x_local):
    step = make_compressed_dp_grad(quad_loss, ctx, "data")
    return step(w, init_error_state(w), x_local)


# ------------------------------------------------------------ pipeline
def tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_body(ctx, stage_params, x_micro):
    return pipeline_forward(tanh_stage, stage_params, x_micro, ctx, "pipe")


def model_stage_body(ctx, stage, x_micro, cfg):
    """A model's stage ``(first, blocks)`` (``pipeline_stages``) in the
    GPipe schedule, ``stage_forward`` as the stage function."""
    return pipeline_forward(functools.partial(stage_forward, cfg=cfg), stage,
                            x_micro, ctx, "pipe")


def matmul_stage(p, x):
    return x @ p["w"]


def pipeline_stage_matmul(ctx, stage_params, x_micro):
    return pipeline_forward(matmul_stage, stage_params, x_micro, ctx, "pipe")


# ------------------------------------------------------------ experts
def _grads(loss, named: dict) -> dict:
    names = list(named)
    got = torch.autograd.grad(loss, [named[k] for k in names],
                              allow_unused=True)
    return {k: (torch.zeros_like(named[k]) if g is None else g)
            for k, g in zip(names, got)}


def moe_ep_body(ctx, params, x, wy, cfg, dist, mode, scale):
    """The EP layer's output, aux and the gradients of
    ``scale * sum(y * wy) + aux`` (``scale``: the data-parallel ranks
    whose mean is the global loss)."""
    dist = dist._replace(ranks=ctx)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    x = x.requires_grad_(True)
    y, aux = moe_ep_fwd(params, x, cfg, dist, mode=mode)
    g = _grads(scale * (y * wy).sum() + aux, {"x": x, **params})
    return y.detach(), aux.detach(), g


def model_ep_body(ctx, params, tokens, labels, cfg, dist):
    """``forward(dist=)``'s logits and aux; ``loss_fn(dist=)``'s loss with
    ``aux_weight=0`` and its gradients, and its loss with the default
    weight."""
    from repro_torch.tree import map_tree, named_leaves
    dist = dist._replace(ranks=ctx)
    with torch.no_grad():
        logits, _, aux = forward(params, tokens, cfg, with_aux=True,
                                 dist=dist)
    ps = map_tree(lambda t: t.detach().requires_grad_(True), params)
    batch = {"tokens": tokens, "labels": labels}
    loss0, _ = loss_fn(ps, batch, cfg, remat=False, aux_weight=0.0,
                       dist=dist)
    grads = _grads(loss0, dict(named_leaves(ps)))
    with torch.no_grad():
        loss, (ce, aux_l) = loss_fn(params, batch, cfg, remat=False,
                                    dist=dist)
    return {"logits": logits, "aux": aux, "loss0": loss0.detach(),
            "grads": grads, "loss": loss, "ce": ce, "aux_l": aux_l}


# ------------------------------------------------------------ failures
def die_on_rank1(ctx):
    """Rank 1 exits at once; the others wait for it in a collective."""
    from repro_torch.distributed.collectives import raw_psum
    if ctx.rank == 1:
        os._exit(3)
    return raw_psum(torch.ones(1), ctx, ctx.mesh.axis_names)


def raise_on_rank0(ctx):
    if ctx.rank == 0:
        raise ValueError("rank 0 refuses")
    return torch.zeros(1)
