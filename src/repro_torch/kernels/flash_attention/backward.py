"""Backward of the flash-attention op, a closed-form formula in torch ops.

The reference has no backward kernel: it trains through XLA's autodiff of
its plain attention.  The port's forward is the CUDA kernel, so the op
``repro_torch::flash_attention`` gets this formula as its autograd rule
(``ops.py``).  It recomputes the scores in f32 with the forward's
placement (query row i at position T - S + i), mask and soft cap, then

    dV = P^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(dO * O));
    dS *= 1 - tanh(s / cap)^2 under a soft cap;
    dQ = scale dS K;  dK = scale dS^T Q,

with dK and dV summed over each GQA group.  Masked pairs get no gradient,
also in a row that every key is masked from (where the forward's finite
mask spreads P uniformly).  It does five (B, HQ, S, T) f32 products, 10 B
HQ S T hd operations, and keeps the scores in device memory, B HQ S T f32
written and read several times over, where a flash backward kernel would
keep them on chip.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask


def flash_attention_bwd(grad_out, q, k, v, out, kv_len=None, *,
                        scale: float, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """(dq, dk, dv) of ``attention_ref(q, k, v, ...)`` given its output
    ``out`` and ``grad_out`` (any strides), each in its input's dtype.
    q: (B,HQ,S,hd); k/v: (B,HKV,T,hd)."""
    b, hq, s_len, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    # query head h reads KV head h // g: group the query heads by KV head
    qf = q.float().reshape(b, hkv, g, s_len, hd)
    kf, vf = k.float(), v.float()
    do = grad_out.float().reshape(b, hkv, g, s_len, hd)
    o = out.float().reshape(b, hkv, g, s_len, hd)
    sc = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale
    if softcap:
        th = torch.tanh(sc / softcap)
        sc = softcap * th
    mask = attention_mask(s_len, t, q.device, causal, window, kv_len)
    p = torch.softmax(torch.where(mask, sc, NEG_INF), dim=-1)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
    dp = torch.einsum("bkgsd,bktd->bkgst", do, vf)
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta), 0.0)
    if softcap:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
