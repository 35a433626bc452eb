"""Plain PyTorch versions of the decode-attention kernels: contiguous
cache, block-table paged pool, and int8 paged pool.

Each takes the reference model's decode options (``mha`` in
``repro/layers/attention.py``): ``softcap`` caps the scaled scores as
``cap * tanh(s / cap)``, then ``window`` masks the keys at ``qpos - kpos >=
window`` with the query at ``qpos = kv_len - 1``, beside the keys at or
past ``kv_len``."""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def _scores(q, kf, scale, softcap):
    s = torch.einsum("bhd,bhtd->bht", q.float(), kf) * scale
    return softcap * torch.tanh(s / softcap) if softcap else s


def _valid(t: int, lens, window: int, device):
    """(B,1,T) keys a row attends: kpos < len, and with a window kpos >
    len - 1 - window."""
    pos = torch.arange(t, device=device)
    lens = torch.as_tensor(lens, device=device).reshape(-1, 1, 1)
    ok = pos < lens
    if window:
        ok &= (lens - 1 - pos) < window
    return ok


def decode_attention_ref(q, k, v, kv_len=None, *, scale: float,
                         window: int = 0, softcap: float = 0.0):
    """q: (B,HQ,hd); k/v: (B,HKV,T,hd); kv_len: None (all T positions), an
    int, or a (B,) integer tensor of per-row lengths.  Positions < kv_len
    (and within ``window`` of position kv_len - 1) are valid; masked scores
    are the finite NEG_INF.  Returns (B,HQ,hd)."""
    t = k.shape[2]
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = _scores(q, kf, scale, softcap)
    if kv_len is not None or window:
        lens = t if kv_len is None else kv_len
        s = torch.where(_valid(t, lens, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, vf).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, kv_lens, *,
                               scale: float, window: int = 0,
                               softcap: float = 0.0):
    """q: (B,HQ,hd); k_pages/v_pages: (P,bs,HKV,hd) pooled token pages;
    block_tables: (B,NB) page ids (entries past a row's length may be any
    value: they are clamped into the pool and masked); kv_lens: (B,) valid
    tokens per row.  Position t of row b lives at
    ``pages[tables[b, t // bs], t % bs]``.  Returns (B,HQ,hd)."""
    b, hq, hd = q.shape
    n_pages, bs, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    safe = block_tables.long().clamp(0, n_pages - 1)
    # each row's logical view: (B,NB,bs,HKV,hd) -> (B,HKV,T,hd)
    kg = k_pages[safe].reshape(b, nb * bs, hkv, hd).transpose(1, 2)
    vg = v_pages[safe].reshape(b, nb * bs, hkv, hd).transpose(1, 2)
    kf = kg.float().repeat_interleave(g, dim=1)
    vf = vg.float().repeat_interleave(g, dim=1)
    s = _scores(q, kf, scale, softcap)
    s = torch.where(_valid(nb * bs, kv_lens, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, vf).to(q.dtype)


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, kv_lens, *, scale: float,
                                     window: int = 0, softcap: float = 0.0):
    """Quantized pool: k_pages/v_pages are (P,bs,HKV,hd) int8 with
    per-(token, head) f32 scales (P,bs,HKV); dequantize the pool in f32
    and defer to ``paged_decode_attention_ref``."""
    kf = k_pages.float() * k_scale.float()[..., None]
    vf = v_pages.float() * v_scale.float()[..., None]
    return paged_decode_attention_ref(q, kf, vf, block_tables, kv_lens,
                                      scale=scale, window=window,
                                      softcap=softcap)
