"""Wrapper of the contiguous decode-attention CUDA kernel
(``csrc/decode_attention.cu``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_ARGS = ([build.P] * 5 + [build.I] * 6 + [build.F] + [build.L] * 10
         + [build.I, build.P])
MAX_GROUP = 8       # query heads per KV head one CTA serves
MAX_HEAD_DIM = 128


def decode_attention(q, k, v, kv_len=None, *, scale: float):
    """q: (B,HQ,hd); k/v: (B,HKV,T,hd); returns (B,HQ,hd).

    ``kv_len``: None (all T positions valid), an int for every row, or a
    (B,) int32 tensor of per-row lengths.  K and V may be any strided views
    with unit stride on hd: the engine passes ``cache.transpose(1, 2)`` of
    its (B,T,HKV,hd) cache, and the kernel reads it in place.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, scale=scale)
    per_row = isinstance(kv_len, torch.Tensor)
    build.require_cuda("decode_attention", q, k, v,
                       *([kv_len] if per_row else []))
    b, hq, hd = q.shape
    _, hkv, t, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hq % hkv or hq // hkv > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: needs HQ % HKV == 0, "
                         f"HQ/HKV <= {MAX_GROUP}, hd <= {MAX_HEAD_DIM}; got "
                         f"HQ={hq} HKV={hkv} hd={hd}")
    if q.dtype != k.dtype or v.dtype != k.dtype:
        raise ValueError("decode_attention: q, k, v must share one dtype")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: head_dim must have unit stride")
    if per_row and (kv_len.shape != (b,) or kv_len.dtype != torch.int32
                    or not kv_len.is_contiguous()):
        raise ValueError("decode_attention: per-row kv_len must be a "
                         "contiguous (B,) int32 tensor")
    out = torch.empty((b, hq, hd), dtype=q.dtype, device=q.device)
    scalar = t if kv_len is None or per_row else int(kv_len)
    fn = build.function("decode_attention_launch", _ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              kv_len.data_ptr() if per_row else None, scalar,
              b, hq, hkv, t, hd, scale,
              q.stride(0), q.stride(1), k.stride(0), k.stride(1),
              k.stride(2), v.stride(0), v.stride(1), v.stride(2),
              out.stride(0), out.stride(1),
              build.dtype_code(q), build.stream_ptr(q))
    build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
