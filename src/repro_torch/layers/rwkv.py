"""RWKV6 (Finch) time mix and channel mix with data-dependent decay.

Counterpart of ``repro/layers/rwkv.py``.  Recurrence per head, state S in
R^{hd x hd}:

    o_t = r_t @ S_{t-1}  +  (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

with w_t = exp(-exp(w0 + lora(x))) in (0, 1) per channel.  The time mix
runs the recurrence through ``kernels.wkv6`` for prefill and decode alike;
``wkv_chunked`` and ``wkv_step`` are its plain versions (the reference's two
execution forms).  Casts follow the reference: r, k, v and logw in f32, g in
the parameter dtype, the per-head norm in f32 then cast to x's dtype before
``o * silu(g)``.

With a cache the layer updates it in place: the shifts are copied into
``state["shift"]`` and the WKV kernel writes the new state over
``state["s"]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6.ref import wkv_chunked, wkv_step  # noqa: F401
from repro_torch.layers.common import dense_init

DECAY_LORA = 64


def rwkv_time_init(gen, cfg: ModelConfig, device) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    half = torch.full((d,), 0.5, dtype=cfg.pdtype, device=device)
    f32 = torch.float32
    return {
        "mix_r": half.clone(), "mix_k": half.clone(), "mix_v": half.clone(),
        "mix_w": half.clone(), "mix_g": half.clone(),
        "wr": dense_init(gen, (d, h * hd), cfg.pdtype, device),
        "wk": dense_init(gen, (d, h * hd), cfg.pdtype, device),
        "wv": dense_init(gen, (d, h * hd), cfg.pdtype, device),
        "wg": dense_init(gen, (d, h * hd), cfg.pdtype, device),
        "wo": dense_init(gen, (h * hd, d), cfg.pdtype, device),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((h * hd,), -6.0, dtype=f32, device=device),
        "wA": dense_init(gen, (d, DECAY_LORA), cfg.pdtype, device),
        "wB": dense_init(gen, (DECAY_LORA, h * hd), cfg.pdtype, device),
        "u": dense_init(gen, (h, hd), f32, device, scale=0.5),
        "ln_scale": torch.ones((h, hd), dtype=f32, device=device),
        "ln_bias": torch.zeros((h, hd), dtype=f32, device=device),
    }


def rwkv_channel_init(gen, cfg: ModelConfig, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full((d,), 0.5, dtype=cfg.pdtype, device=device),
        "wk": dense_init(gen, (d, f), cfg.pdtype, device),
        "wv": dense_init(gen, (f, d), cfg.pdtype, device),
    }


def make_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """One layer's recurrent cache: the time mix's and the channel mix's
    last token (``shift``, ``shift_c``) and the f32 WKV state ``s``."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {"shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "shift_c": torch.zeros((batch, d), dtype=dtype, device=device)}


def _token_shift(x, prev, mix):
    """x: (B,S,D); prev: (B,D) last token of the previous segment."""
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return x + mix.to(x.dtype) * (shifted - x)


def _head_ln(o, scale, bias, eps: float = 1e-5):
    """Per-head layer norm in f32 (RWKV's GroupNorm with groups == heads)."""
    of = o.float()
    mu = of.mean(dim=-1, keepdim=True)
    var = of.var(dim=-1, keepdim=True, unbiased=False)
    return (of - mu) * torch.rsqrt(var + eps) * scale + bias


def _rkvwg(params, x, cfg: ModelConfig, prev):
    """Project the token-shifted activations to r, k, v, logw, g."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    xr, xk, xv, xw, xg = (_token_shift(x, prev, params[f"mix_{n}"])
                          for n in "rkvwg")
    r = (xr @ params["wr"]).float().reshape(b, s, h, hd)
    k = (xk @ params["wk"]).float().reshape(b, s, h, hd)
    v = (xv @ params["wv"]).float().reshape(b, s, h, hd)
    g = xg @ params["wg"]
    lora = torch.tanh(xw @ params["wA"]) @ params["wB"]
    logw = -torch.exp(params["w0"] + lora.float())                # <= 0
    return r, k, v, logw.reshape(b, s, h, hd), g


def rwkv_time_fwd(params, x, cfg: ModelConfig, state=None):
    """Time mix over a segment x (B,S,D).  ``state``: one layer's cache
    (``make_state``), updated in place; None starts from zeros."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    if state is None:
        prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
        s_out = None
    else:
        prev, s0 = state["shift"], state["s"]
        s_out = s0
    r, k, v, logw, g = _rkvwg(params, x, cfg, prev)
    o, _ = kernels.wkv6(r, k, v, logw, params["u"], s0, s_out=s_out)
    o = _head_ln(o, params["ln_scale"], params["ln_bias"])
    o = o.reshape(b, s, h * hd).to(x.dtype) * F.silu(g)
    if state is not None:
        state["shift"].copy_(x[:, -1])
    return o @ params["wo"]


def rwkv_channel_fwd(params, x, cfg: ModelConfig, state=None):
    """Channel mix (squared-ReLU FFN with token shift) over x (B,S,D);
    ``state["shift_c"]`` updated in place."""
    prev = (torch.zeros_like(x[:, 0]) if state is None
            else state["shift_c"])
    xk = _token_shift(x, prev, params["mix_k"])
    out = torch.square(F.relu(xk @ params["wk"])) @ params["wv"]
    if state is not None:
        state["shift_c"].copy_(x[:, -1])
    return out
