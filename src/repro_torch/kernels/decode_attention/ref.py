"""Plain PyTorch version of the contiguous decode-attention kernel."""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def decode_attention_ref(q, k, v, kv_len=None, *, scale: float):
    """q: (B,HQ,hd); k/v: (B,HKV,T,hd); kv_len: None (all T positions), an
    int, or a (B,) integer tensor of per-row lengths.  Positions < kv_len
    are valid; masked scores are the finite NEG_INF.  Returns (B,HQ,hd)."""
    t = k.shape[2]
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhd,bhtd->bht", q.float(), kf) * scale
    if kv_len is not None:
        lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1)
        s = torch.where(torch.arange(t, device=q.device) < lens, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, vf).to(q.dtype)
