"""Plain PyTorch versions of the WKV6 recurrence (RWKV-6 time mix).

Per batch row and head, with state S in R^{hd x hd} (f32):

    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
    S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t

``wkv6_ref`` takes the branches the reference layer takes
(``repro/layers/rwkv.py::rwkv_time_fwd``): one token through ``wkv_step``,
more through ``wkv_chunked`` after padding T to a multiple of ``CHUNK``
with zero r/k/v and zero log-decay (w = 1), which leaves the state as it
was.  ``wkv6_oracle`` runs the recurrence literally, in float64, for the
tests.  Every tensor is in the layer's (B, T, H, hd) layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 16


def wkv_chunked(r, k, v, logw, u, s0, chunk: int = CHUNK):
    """Chunked-parallel WKV6 (``repro/layers/rwkv.py::wkv_chunked``).

    r, k, v, logw: (B,T,H,hd) f32 with T a multiple of ``chunk``; u: (H,hd);
    s0: (B,H,hd,hd).  Within a chunk the pairwise decays are taken in log
    space, so every ``exp`` argument is <= 0.  Returns (o (B,T,H,hd), sT).
    """
    b, t, h, hd = r.shape
    if t % chunk:
        raise ValueError(f"wkv_chunked: T={t} is not a multiple of {chunk}")
    n = t // chunk

    def split(a):                                   # (n, B, H, C, hd)
        return a.reshape(b, n, chunk, h, hd).permute(1, 0, 3, 2, 4)

    rs, ks, vs, lws = (split(a) for a in (r, k, v, logw))
    strict = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=r.device).tril(-1)
    eye = torch.eye(chunk, dtype=torch.float32, device=r.device)
    s = s0
    outs = []
    for rc, kc, vc, lw in zip(rs, ks, vs, lws):
        cum = lw.cumsum(2)                                   # inclusive
        cum_exc = cum - lw                                   # exclusive
        pair = cum_exc[:, :, :, None, :] - cum[:, :, None, :, :]
        pair = pair.masked_fill(~strict[None, None, :, :, None],
                                float("-inf"))
        a = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, pair.exp())
        diag = torch.einsum("bhti,hi,bhti->bht", rc, u, kc)
        a = a + diag[..., None] * eye
        outs.append(a @ vc + (rc * cum_exc.exp()) @ s)
        tot = cum[:, :, -1:, :]
        s = tot[:, :, 0, :].exp()[..., None] * s + \
            (kc * (tot - cum).exp()).transpose(-1, -2) @ vc
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, t, h, hd)
    return o, s


def wkv_step(r, k, v, logw, u, s):
    """One token (``repro/layers/rwkv.py::wkv_step``).  r, k, v, logw:
    (B,H,hd); s: (B,H,hd,hd).  Returns (o (B,H,hd), s_new)."""
    rkv = torch.einsum("bhi,hi,bhi->bh", r, u, k)[..., None] * v
    o = torch.einsum("bhi,bhij->bhj", r, s) + rkv
    s_new = logw.exp()[..., None] * s + k[..., :, None] * v[..., None, :]
    return o, s_new


def wkv6_ref(r, k, v, logw, u, s0, *, s_out=None):
    """The reference layer's WKV6: r, k, v, logw (B,T,H,hd) f32, u (H,hd),
    s0 (B,H,hd,hd).  Returns (o (B,T,H,hd), sT); with ``s_out`` (which may
    be ``s0``) sT is copied there and ``s_out`` returned, as the kernel's
    wrapper does."""
    t = r.shape[1]
    if t == 1:
        o, s = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, s0)
        o = o[:, None]
    else:
        pad = (-t) % CHUNK
        if pad:
            r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                             for a in (r, k, v, logw))
        o, s = wkv_chunked(r, k, v, logw, u, s0)
        o = o[:, :t]
    return o, (s if s_out is None else s_out.copy_(s))


def wkv6_oracle(r, k, v, logw, u, s0):
    """The recurrence executed literally, step by step, in float64; same
    layout and return as ``wkv6_ref``, in f32."""
    r, k, v, logw, u, s = (a.double() for a in (r, k, v, logw, u, s0))
    o = torch.empty_like(r)
    for ti in range(r.shape[1]):
        rt, kt, vt = r[:, ti], k[:, ti], v[:, ti]              # (B,H,hd)
        bonus = (rt * u * kt).sum(-1, keepdim=True) * vt
        o[:, ti] = torch.einsum("bhi,bhij->bhj", rt, s) + bonus
        s = logw[:, ti].exp()[..., None] * s + \
            kt[..., :, None] * vt[..., None, :]
    return o.float(), s.float()
