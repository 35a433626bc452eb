"""Wrapper of the WKV6 CUDA kernel (``csrc/wkv6.cu``).

The wrapper calls the custom op ``repro_torch::wkv6``, which writes the
final state into ``s_out`` in place: its CPU implementation is the plain
version (``ref.py``), its CUDA implementation launches the kernel or
raises, and its fake implementation gives a tracer the output's shape.
``wkv6.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6.ref import wkv6_ref

_ARGS = [build.P] * 8 + [build.I] * 4 + [build.L] * 3 + [build.P]
HEAD_DIMS = (8, 16, 32, 64, 128)    # the kernel's compiled head sizes


def wkv6(r, k, v, logw, u, s0, *, s_out=None):
    """r, k, v, logw: (B,T,H,hd) f32, T >= 1; u: (H,hd) f32; s0:
    (B,H,hd,hd) f32.  Returns (o (B,T,H,hd) f32, sT (B,H,hd,hd) f32).

    r, k, v and logw may be any views with one set of strides and unit
    stride on hd (the layer passes its projections as they are).  With
    ``s_out`` the final state is written there and returned; it may be
    ``s0`` itself, so the cache's state is updated in place.
    """
    build.require_placed("wkv6", r)
    if s_out is None:
        s_out = torch.empty_like(s0)
    return _op._opoverload(r, k, v, logw, u, s0, s_out), s_out


@torch.library.custom_op("repro_torch::wkv6", mutates_args=("s_out",),
                         device_types="cpu")
def _op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
        s_out: torch.Tensor) -> torch.Tensor:
    return wkv6_ref(r, k, v, logw, u, s0, s_out=s_out)[0].contiguous()


@_op.register_kernel("cuda")
def _launch(r, k, v, logw, u, s0, s_out):
    seq = (r, k, v, logw)
    states = (s0, s_out)
    build.require_cuda("wkv6", *seq, u, *states)
    if r.dim() != 4 or any(a.shape != r.shape for a in seq):
        raise ValueError("wkv6: r, k, v, logw must share one (B,T,H,hd) "
                         f"shape, got {[tuple(a.shape) for a in seq]}")
    b, t, h, hd = r.shape
    if t < 1 or hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: needs T >= 1 and hd in {HEAD_DIMS}, got "
                         f"T={t} hd={hd}")
    if any(a.stride() != r.stride() for a in seq) or r.stride(3) != 1:
        raise ValueError("wkv6: r, k, v, logw must share strides, with unit"
                         " stride on hd")
    if u.shape != (h, hd) or any(s.shape != (b, h, hd, hd) for s in states):
        raise ValueError(f"wkv6: u {tuple(u.shape)} must be (H,hd) and the "
                         f"states {[tuple(s.shape) for s in states]} "
                         "(B,H,hd,hd)")
    if any(a.dtype != torch.float32 for a in (*seq, u, *states)):
        raise ValueError("wkv6: every tensor must be float32")
    if not all(a.is_contiguous() for a in (u, *states)):
        raise ValueError("wkv6: u and the states must be contiguous")
    o = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    fn = build.function("wkv6_launch", _ARGS)
    code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
              u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_out.data_ptr(),
              b, t, h, hd, r.stride(0), r.stride(1), r.stride(2),
              build.stream_ptr(r))
    build.check(code, "wkv6")
    wkv6.launches += 1
    return o


@_op.register_fake
def _fake(r, k, v, logw, u, s0, s_out):
    return r.new_empty(r.shape)


def _costs(r, k, v, logw, u, s0, s_out) -> tuple:
    """(flops, bytes): per token and head about 8 hd^2 operations (the
    state's decay and update and the read-out), r, k, v, logw, u, both
    states and the output moved once."""
    b, t, h, hd = r.shape
    return 8.0 * b * t * h * hd * hd, float(
        build.nbytes(r, k, v, logw, u, s0, s_out, r))


wkv6.launches = 0
wkv6.op = _op._opoverload
wkv6.costs = _costs
