"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

The wrapper calls a ``torch.library`` custom op: its CPU implementation is
the plain version (``ref.py``), its CUDA implementation launches the kernel
or raises, its fake implementation gives a tracer the output's shape
and strides, so a trace of the step holds each launch as one node, and its
autograd rule is the closed-form backward of ``backward.py``.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import attention_ref

_ARGS = ([build.P] * 4 + [build.I] * 6 + [build.F, build.I, build.I,
                                          build.F, build.I, build.I]
         + [build.L] * 12 + [build.I, build.P])
MAX_HEAD_DIM = 128


def flash_attention(q, k, v, kv_len=None, *, scale: float, causal=True,
                    window: int = 0, softcap: float = 0.0):
    """q: (B,HQ,S,hd); k/v: (B,HKV,T,hd); kv_len: None (-> T) or an int.
    Returns (B,HQ,S,hd), query row i at position T - S + i.

    Any strides with unit stride on hd are read in place.  On the card the
    result is a (B,HQ,S,hd) view of a token-major (B,S,HQ,hd) buffer, so
    ``out.transpose(1, 2)`` is contiguous for the output projection.
    """
    build.require_placed("flash_attention", q)
    return _flash_op._opoverload(
        q, k, v, -1 if kv_len is None else int(kv_len), float(scale),
        bool(causal), int(window), float(softcap))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len: int, scale: float, causal: bool, window: int,
              softcap: float) -> torch.Tensor:
    return attention_ref(q, k, v, None if kv_len < 0 else kv_len,
                         scale=scale, causal=causal, window=window,
                         softcap=softcap).contiguous()


@_flash_op.register_kernel("cuda")
def _flash_launch(q, k, v, kv_len, scale, causal, window, softcap):
    build.require_cuda("flash_attention", q, k, v)
    b, hq, s, hd = q.shape
    _, hkv, t, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hq % hkv or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: needs HQ % HKV == 0 and hd <= "
                         f"{MAX_HEAD_DIM}; got HQ={hq} HKV={hkv} hd={hd}")
    if q.dtype != k.dtype or v.dtype != k.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: head_dim must have unit stride")
    out = _flash_fake(q, k, v, kv_len, scale, causal, window, softcap)
    fn = build.function("flash_attention_launch", _ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              b, hq, hkv, s, t, hd, scale, int(causal), window,
              softcap, t if kv_len < 0 else kv_len, t - s,
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              out.stride(0), out.stride(1), out.stride(2),
              build.dtype_code(q), build.stream_ptr(q))
    build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, kv_len, scale, causal, window, softcap):
    """The output's layout: token-major on the card, as the kernel writes
    it; the plain version's (B,HQ,S,hd) on the CPU."""
    b, hq, s, hd = q.shape
    if q.device.type == "cpu":
        return q.new_empty((b, hq, s, hd))
    return q.new_empty((b, s, hq, hd)).transpose(1, 2)


def _flash_setup(ctx, inputs, output):
    q, k, v, kv_len, scale, causal, window, softcap = inputs
    # the output itself (on the card a view of the token-major buffer),
    # not a copy of it
    ctx.save_for_backward(q, k, v, output)
    ctx.opts = dict(kv_len=None if kv_len < 0 else kv_len, scale=scale,
                    causal=causal, window=window, softcap=softcap)


def _flash_backward(ctx, grad_out):
    q, k, v, out = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(grad_out, q, k, v, out, **ctx.opts)
    return dq, dk, dv, None, None, None, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def _flash_costs(q, k, v, kv_len, scale, causal, window, softcap) -> tuple:
    """(flops, bytes): the two products over every (query, key) pair, and
    Q, K, V and the output moved once."""
    b, hq, s, hd = q.shape
    t = k.shape[2]
    return 4.0 * b * hq * s * t * hd, float(build.nbytes(q, k, v, q))


flash_attention.launches = 0
flash_attention.op = _flash_op._opoverload
flash_attention.costs = _flash_costs
