"""Backward of the WKV6 recurrence (``repro_torch::wkv6_fn``), a closed
form in torch ops registered as the functional op's autograd rule
(``ops.py``).

The reference has no backward kernel: JAX differentiates its chunked
recurrence.  This follows the same chunked form (``ref.wkv_chunked``,
chunks of ``CHUNK`` steps, T padded with zero r/k/v/logw), per batch row
and head, with the state S (hd_k x hd_v).  In a chunk, with the inclusive
and exclusive log-decay sums c_t = sum_{tau<=t} logw_tau, e_t = c_t - logw_t
and the chunk's total c = c_{C-1}:

    A[t,s] = sum_i r_t[i] k_s[i] exp(e_t[i] - c_s[i])   (s < t)
    A[t,t] = sum_i r_t[i] u[i] k_t[i]
    o_t    = sum_s A[t,s] v_s + (r_t * exp(e_t)) S
    S'     = diag(exp(c)) S + sum_s (k_s * exp(c - c_s))^T v_s

Given do and dS' the chunk gives, with dA[t,s] = do_t . v_s:

    dv_s = sum_t A[t,s] do_t + (k_s * exp(c - c_s)) dS'
    dr_t = sum_{s<t} dA[t,s] k_s exp(e_t - c_s) + dA[t,t] u k_t
           + exp(e_t) * (S do_t)
    dk_s = sum_{t>s} dA[t,s] r_t exp(e_t - c_s) + dA[s,s] u r_s
           + exp(c - c_s) * (dS' v_s)
    du   = sum_t dA[t,t] r_t k_t
    dS   = diag(exp(c)) dS' + sum_t (r_t * exp(e_t))^T do_t

and dlogw through the sums: de_t and dc_s collect every term in which
e_t and c_s appear (the pairwise term, the state read, the state
carried), and dlogw_tau = sum_{t>=tau} dc_t + sum_{t>tau} de_t.  Every
pairwise decay is taken in log space, so no ``exp`` argument exceeds 0
(the forward's guarantee, kept in the backward).  Only the states run
chunk by chunk: the state entering each chunk forward, the gradient dS
of the state leaving it backward (dS_{t-1} = diag(exp logw_t) dS_t +
r_t^T do_t within a chunk, in closed form across it); every chunk's
gradients are then taken at once.  All in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6.ref import CHUNK


def _chunk_bwd(rc, kc, vc, lw, u, s, do, ds_next, strict, eye):
    """One chunk's backward.  rc, kc, vc, lw, do: (B,H,C,hd); s: the
    state entering the chunk (B,H,hd,hd); ds_next: the gradient of the
    state leaving it.  Returns (dr, dk, dv, dlw, du (B,H,hd), ds)."""
    cum = lw.cumsum(2)
    exc = cum - lw
    tot = cum[:, :, -1:, :]                                  # (B,H,1,hd)
    pair = exc[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,H,t,s,i)
    pair = pair.masked_fill(~strict[None, None, :, :, None], float("-inf"))
    dec = pair.exp()
    a = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, dec)
    diag = torch.einsum("bhti,hi,bhti->bht", rc, u, kc)
    a = a + diag[..., None] * eye
    da = do @ vc.transpose(-1, -2)                           # (B,H,t,s)
    da_off = da * strict
    da_diag = torch.diagonal(da, dim1=-2, dim2=-1)           # (B,H,C)
    kdec = (tot - cum).exp()                                 # (B,H,C,hd)
    kd = kc * kdec
    dv = a.transpose(-1, -2) @ do + kd @ ds_next
    # the pairwise term P[t,s,i] = dA[t,s] r_t[i] k_s[i] exp(e_t - c_s)
    p = da_off[..., None] * rc[:, :, :, None, :] * kc[:, :, None, :, :] \
        * dec
    sdo = do @ s.transpose(-1, -2)                           # (B,H,C,hd_k)
    q = rc * exc.exp()
    dr = torch.einsum("bhts,bhsi,bhtsi->bhti", da_off, kc, dec) \
        + da_diag[..., None] * u[None, :, None, :] * kc + exc.exp() * sdo
    dsv = vc @ ds_next.transpose(-1, -2)                     # (B,H,C,hd_k)
    dk = torch.einsum("bhts,bhti,bhtsi->bhsi", da_off, rc, dec) \
        + da_diag[..., None] * u[None, :, None, :] * rc + kdec * dsv
    du = (da_diag[..., None] * rc * kc).sum(dim=(0, 2))
    # d e_t and d c_s
    d_exc = p.sum(dim=3) + q * sdo
    r_term = kd * dsv                                        # R[s,i]
    d_cum = -p.sum(dim=2) - r_term
    d_tot = (tot[:, :, 0, :].exp() * (s * ds_next).sum(-1)) + r_term.sum(2)
    d_cum[:, :, -1, :] += d_tot
    dlw = d_cum.flip(2).cumsum(2).flip(2) \
        + (d_exc.flip(2).cumsum(2).flip(2) - d_exc)
    ds = tot[:, :, 0, :].exp()[..., None] * ds_next + q.transpose(-1, -2) @ do
    return dr, dk, dv, dlw, du, ds


def wkv6_bwd(r, k, v, logw, u, s0, do, ds_out):
    """(dr, dk, dv, dlogw, du, ds0) of ``(o, sT) = wkv6(r, k, v, logw, u,
    s0)`` given ``do`` (B,T,H,hd) and ``ds_out`` (B,H,hd,hd) (either may
    be None: zeros), all f32."""
    b, t, h, hd = r.shape
    f32 = torch.float32
    if do is None:
        do = torch.zeros((b, t, h, hd), dtype=f32, device=r.device)
    if ds_out is None:
        ds_out = torch.zeros((b, h, hd, hd), dtype=f32, device=r.device)
    pad = (-t) % CHUNK
    seq = [a.float() for a in (r, k, v, logw, do)]
    if pad:
        seq = [F.pad(a, (0, 0, 0, 0, 0, pad)) for a in seq]
    n = (t + pad) // CHUNK

    def split(a):                                   # (n, B, H, C, hd)
        return a.reshape(b, n, CHUNK, h, hd).permute(1, 0, 3, 2, 4)

    rs, ks, vs, lws, dos = (split(a) for a in seq)
    u = u.float()
    strict = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                        device=r.device).tril(-1)
    eye = torch.eye(CHUNK, dtype=f32, device=r.device)
    cum = lws.cumsum(3)                                    # (n,B,H,C,hd)
    tot = cum[:, :, :, -1:, :]
    decay = tot[:, :, :, 0, :].exp()[..., None]            # (n,B,H,hd,1)
    carry = (ks * (tot - cum).exp()).transpose(-1, -2) @ vs
    q = rs * (cum - lws).exp()
    back = q.transpose(-1, -2) @ dos                       # (n,B,H,hd,hd)
    # the state entering each chunk and the gradient of the state leaving
    # it: the only sequential part, a few ops a chunk
    states, ds_next = [s0.float()], [None] * n
    for c in range(n - 1):
        states.append(decay[c] * states[-1] + carry[c])
    ds = ds_out.float()
    for c in range(n - 1, -1, -1):
        ds_next[c] = ds
        ds = decay[c] * ds + back[c]

    def flat(a):                                   # (n*B, H, ...)
        return a.reshape((n * b,) + tuple(a.shape[2:]))

    dr, dk, dv, dlw, du, _ = _chunk_bwd(
        flat(rs), flat(ks), flat(vs), flat(lws), u,
        flat(torch.stack(states)), flat(dos), flat(torch.stack(ds_next)),
        strict, eye)

    def join(a):
        out = a.reshape(n, b, h, CHUNK, hd).permute(1, 0, 3, 2, 4)
        return out.reshape(b, n * CHUNK, h, hd)[:, :t]

    return join(dr), join(dk), join(dv), join(dlw), du, ds
