"""Plain PyTorch version of the flash-attention kernel (BHSD layout, GQA)."""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def attention_ref(q, k, v, kv_len=None, *, scale: float, causal: bool = True,
                  window: int = 0, softcap: float = 0.0):
    """q: (B,HQ,S,hd); k/v: (B,HKV,T,hd); kv_len: None or an int bound.

    Queries are right-aligned: query row i sits at position T - S + i.
    Dense f32 scores, the finite NEG_INF mask, f32 softmax.  Returns
    (B,HQ,S,hd) in q's dtype.
    """
    s_len, t = q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    sc = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    qpos = torch.arange(s_len, device=q.device)[:, None] + (t - s_len)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s_len, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    if kv_len is not None:
        mask &= kpos < kv_len
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
