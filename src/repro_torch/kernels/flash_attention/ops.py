"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
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
    if q.device.type == "cpu":
        return attention_ref(q, k, v, kv_len, scale=scale, causal=causal,
                             window=window, softcap=softcap)
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
    out = torch.empty((b, s, hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    fn = build.function("flash_attention_launch", _ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              b, hq, hkv, s, t, hd, scale, int(bool(causal)), int(window),
              float(softcap), t if kv_len is None else int(kv_len), t - s,
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              out.stride(0), out.stride(1), out.stride(2),
              build.dtype_code(q), build.stream_ptr(q))
    build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
