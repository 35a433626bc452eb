"""Int8 KV-cache quantization for the paged pool.

Copy of the functions of ``repro/inference/kv_quant.py``: those the paged
cache uses, and the contiguous int8 cache (``make_quantized_cache``,
``write_kv``, ``read_kv``: (B, T, HKV, hd) int8 payloads beside
(B, T, HKV) f32 scales, written in place at a position).  Per-(token, head) symmetric quantization: a K/V row (hd,)
becomes an int8 payload plus one f32 scale, so a cached entry costs
``hd + 4`` bytes instead of ``2 * hd`` (bf16).  The scale is
``max(|x|, 1e-8) / 127``, the payload ``round(x / scale)`` (half to even,
as ``jnp.round``) clipped to +-127: payloads and scales are bit-identical
to the reference's on the same f32 input.  Dequantization happens at load
time, inside the paged decode kernel (``kernels.paged_decode_attention``)
and in the prefill gather (``layers.attention``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

KV_DTYPES = ("bf16", "int8")


def kv_entry_bytes(hd: int, kv_dtype: str = "bf16") -> int:
    """Cache bytes per (token, head) entry: int8 payload + f32 scale vs
    bf16 payload."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return hd + 4 if kv_dtype == "int8" else 2 * hd


def capacity_ratio(hd: int) -> float:
    """How many int8 entries fit in the bytes of one bf16 entry
    (2*hd / (hd+4): ~1.88x at hd=64)."""
    return kv_entry_bytes(hd, "bf16") / kv_entry_bytes(hd, "int8")


def quantize_kv(x: torch.Tensor):
    """x: (..., hd) -> (int8 payload, f32 scale (...,))."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def make_quantized_cache(batch: int, max_len: int, n_kv: int, hd: int, *,
                         device="cuda") -> dict:
    """A contiguous int8 KV cache of zeros: {"k","v"} (B,T,HKV,hd) int8,
    {"k_scale","v_scale"} (B,T,HKV) f32."""
    dev = resolve_device(device)
    return {
        "k": torch.zeros((batch, max_len, n_kv, hd), dtype=torch.int8,
                         device=dev),
        "v": torch.zeros((batch, max_len, n_kv, hd), dtype=torch.int8,
                         device=dev),
        "k_scale": torch.zeros((batch, max_len, n_kv), dtype=torch.float32,
                               device=dev),
        "v_scale": torch.zeros((batch, max_len, n_kv), dtype=torch.float32,
                               device=dev),
    }


def write_kv(cache: dict, k, v, index: int) -> dict:
    """Quantize k/v (B,S,HKV,hd) into positions [index, index + S) of every
    row, in place; returns the cache."""
    end = int(index) + k.shape[1]
    if end > cache["k"].shape[1]:
        raise ValueError(f"write [{index}, {end}) past the cache's "
                         f"{cache['k'].shape[1]} positions")
    for name, x in (("k", k), ("v", v)):
        q, scale = quantize_kv(x)
        cache[name][:, index:end] = q
        cache[f"{name}_scale"][:, index:end] = scale
    return cache


def read_kv(cache: dict, dtype=torch.bfloat16) -> tuple:
    """The whole cache dequantized: (k, v) (B,T,HKV,hd) in ``dtype``."""
    return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
            dequantize_kv(cache["v"], cache["v_scale"], dtype))
