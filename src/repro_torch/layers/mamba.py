"""Mamba (S6) selective-state-space mixer, used by the Jamba hybrid stack.

Counterpart of ``repro/layers/mamba.py``.  State per layer:
{"conv": (B, d_conv-1, d_inner) in the activation dtype, "h": (B, d_inner,
d_state) f32}.  The reference scans a segment in chunks of ``TIME_CHUNK``
steps after padding it with dt = 0, which leaves h as it is (exp(0) = 1,
the input term 0); the port runs the same step over the segment's own
steps, in the same order, so h and every output agree.  The causal conv
sums its K products in the activation dtype, in order, as the reference.

A segment longer than ``TIME_CHUNK`` steps (a long prefill, a training
sequence) is cut into about sqrt(S) blocks of about sqrt(S) steps and
scanned in two levels: the same step runs in every block at once from a
zero state, then the state carries from block to block, h_in(j+1) =
exp(A sum_{tau in j} dt_tau) h_in(j) + h_end(j), and each step adds
exp(A sum_{tau<=t in its block} dt_tau) h_in(its block) (every exponent
<= 0).  The same function in another summation order (f32, about 1e-6 of
the values), in about 3 sqrt(S) steps of a few ops each, whose tensors
are (B, S / block, d_inner, d_state): what a step saves for the backward
adds up to a few times the per-step scan's, (B, S, d_inner, d_state) f32
each.

The model hands ``mamba_fwd`` the input projection it computed with the
layer's norm (``kernels.rmsnorm_matmul``, where the reference's fused
plan puts it); ``x @ in_proj`` is computed here only without it.  With a
state the layer updates it in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import dense_init

TIME_CHUNK = 256


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_inner, m.d_state, m.d_conv, dt_rank


def mamba_init(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    d_inner, d_state, d_conv, dt_rank = _dims(cfg)
    f32 = torch.float32
    a = torch.arange(1, d_state + 1, dtype=f32, device=device)[None]
    return {
        "in_proj": dense_init(gen, (d, 2 * d_inner), cfg.pdtype, device),
        "conv_w": dense_init(gen, (d_conv, d_inner), cfg.pdtype, device,
                             scale=0.1),
        "conv_b": torch.zeros((d_inner,), dtype=cfg.pdtype, device=device),
        "x_proj": dense_init(gen, (d_inner, dt_rank + 2 * d_state),
                             cfg.pdtype, device),
        "dt_w": dense_init(gen, (dt_rank, d_inner), cfg.pdtype, device),
        "dt_b": torch.full((d_inner,), -4.6, dtype=f32, device=device),
        "A_log": torch.log(a.expand(d_inner, d_state)).contiguous(),
        "D": torch.ones((d_inner,), dtype=f32, device=device),
        "out_proj": dense_init(gen, (d_inner, d), cfg.pdtype, device),
    }


def make_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_inner, d_state, d_conv, _ = _dims(cfg)
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                             device=device)}


def _conv_causal(x, w, b, prev):
    """Depthwise causal conv.  x: (B,S,di); w: (K,di); prev: (B,K-1,di).
    Returns (out (B,S,di), the new conv state (B,K-1,di))."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)                 # (B,S+K-1,di)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b.to(x.dtype), xp[:, -(k - 1):]


def _ssm_params(params, xc, cfg: ModelConfig, reduce=None):
    """xc: (B,S,di) post-conv activations -> dt (B,S,di), Bm/Cm (B,S,ds)."""
    _, d_state, _, dt_rank = _dims(cfg)
    proj = xc @ params["x_proj"]
    if reduce is not None:
        proj = reduce("mamba_xproj", proj)
    proj = proj.float()
    dt, bm, cm = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ params["dt_w"].float() + params["dt_b"])
    return dt, bm, cm


def _scan_chunk(h, xs, a):
    """Per-step selective scan.  h: (B,di,ds); xs = (xc, dt, bm, cm), each
    (B,C,...); a: (di,ds) = -exp(A_log).  Returns (h, ys (B,C,di))."""
    xc, dt, bm, cm = xs
    ys = []
    for t in range(xc.shape[1]):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a)                       # (B,di,ds)
        dbx = (dt_t * xc[:, t])[..., None] * bm[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, cm[:, t]))
    return h, torch.stack(ys, dim=1)


def _scan_blocks(h, xs, a):
    """The selective scan of a long segment in two levels (see the module's
    docstring).  Same arguments and returns as ``_scan_chunk``."""
    xc, dt, bm, cm = xs
    b, s, di = xc.shape
    n = math.isqrt(s - 1) + 1                            # steps a block
    nb = -(-s // n)
    # padded steps have dt = 0: they leave h as it is
    xc, dt, bm, cm = (F.pad(t, (0, 0, 0, nb * n - s)).reshape(
        b, nb, n, t.shape[-1]) for t in (xc, dt, bm, cm))
    hl = h.new_zeros((b, nb) + tuple(h.shape[1:]))       # (B,nb,di,ds)
    ys = []
    for t in range(n):
        dt_t = dt[:, :, t]
        dbx = (dt_t * xc[:, :, t])[..., None] * bm[:, :, t, None, :]
        hl = torch.exp(dt_t[..., None] * a) * hl + dbx
        ys.append(torch.einsum("bjds,bjs->bjd", hl, cm[:, :, t]))
    cum = dt.cumsum(dim=2)                               # (B,nb,n,di)
    decay = torch.exp(cum[:, :, -1, :, None] * a)        # a block's whole
    h_in = []
    for j in range(nb):
        h_in.append(h)
        h = decay[:, j] * h + hl[:, j]
    h_in = torch.stack(h_in, dim=1)
    for t in range(n):
        carried = torch.exp(cum[:, :, t, :, None] * a) * h_in
        ys[t] = ys[t] + torch.einsum("bjds,bjs->bjd", carried, cm[:, :, t])
    return h, torch.stack(ys, dim=2).reshape(b, nb * n, di)[:, :s]


def mamba_fwd(params, x, cfg: ModelConfig, state=None, xz=None,
              reduce=None):
    """x: (B,S,D) -> (out (B,S,D), state).  ``xz``: ``x @ in_proj`` when the
    caller computed it; ``state`` is updated in place.  ``reduce``: the
    tensor-parallel hook inside a rank, whose ``params`` then hold the
    rank's block of d_inner (``in_proj`` its x and z columns, ``x_proj`` and
    ``out_proj`` its rows): the ``x_proj`` and ``out_proj`` products are its
    partial sums, all-reduced by ``reduce``."""
    b, s, _ = x.shape
    if xz is None:
        xz = x @ params["in_proj"]
    xr, z = xz.chunk(2, dim=-1)
    fresh = state is None
    if fresh:
        _, d_state, d_conv, _ = _dims(cfg)
        di = xr.shape[-1]
        state = {"conv": x.new_zeros((b, d_conv - 1, di)),
                 "h": torch.zeros((b, di, d_state), dtype=torch.float32,
                                  device=x.device)}
    xc, conv_state = _conv_causal(xr, params["conv_w"], params["conv_b"],
                                  state["conv"])
    xc = F.silu(xc)
    dt, bm, cm = _ssm_params(params, xc, cfg, reduce)
    a = -torch.exp(params["A_log"])                               # (di,ds)
    xcf = xc.float()
    scan = _scan_blocks if s > TIME_CHUNK else _scan_chunk
    h, ys = scan(state["h"], (xcf, dt, bm, cm), a)
    y = ys + params["D"] * xcf
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    if reduce is not None:
        out = reduce("mamba_out", out)
    if fresh:
        return out, {"conv": conv_state, "h": h}
    state["conv"].copy_(conv_state)
    state["h"].copy_(h)
    return out, state
