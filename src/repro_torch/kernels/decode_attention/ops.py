"""Wrappers of the decode-attention CUDA kernels: the contiguous cache
(``csrc/decode_attention.cu``) and the block-table paged pool in bf16/f32
or int8 (``csrc/paged_decode_attention.cu``).

Each wrapper calls a ``torch.library`` custom op: its CPU implementation
is the plain version (``ref.py``), its CUDA implementation launches the
kernel or raises, and its fake implementation gives a tracer the output's
shape, so a trace of the step (``core/tracing.py``) holds each launch as
one node.  ``decode_attention.launches``,
``paged_decode_attention.launches`` and
``paged_decode_attention_quant.launches`` count kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_quant_ref,
    paged_decode_attention_ref)

_ARGS = ([build.P] * 5 + [build.I] * 6 + [build.F, build.I, build.F]
         + [build.L] * 10
         + [build.I, build.I, build.P, build.P, build.I, build.P])
_PAGED_ARGS = ([build.P] * 6 + [build.I] * 7 + [build.F, build.I, build.F]
               + [build.L] * 11
               + [build.I, build.I, build.P, build.P, build.I, build.P])
_PAGED_QUANT_ARGS = ([build.P] * 8 + [build.I] * 7
                     + [build.F, build.I, build.F] + [build.L] * 17
                     + [build.I, build.I, build.P, build.P, build.I, build.P])
MAX_GROUP = 8       # query heads per KV head one CTA serves
MAX_HEAD_DIM = 128
MAX_ROWS = 65535    # grid.y
SPLIT_MIN = 128     # positions one CTA takes before a call splits
TARGET_CTAS = 264   # two waves of the H100's 132 SMs
WARPS, POSITIONS_PER_LANE_GROUP = 4, 2    # csrc/decode_attention.cuh


def split_plan(t_len: int, rows: int, kv_heads: int) -> tuple:
    """(splits, positions per split) of a call over ``t_len`` positions
    (T, or NB * bs when paged): from the static shapes only, never the
    device lengths.  One split up to SPLIT_MIN positions (the main path's T
    = 128); longer caches split into runs of at least SPLIT_MIN until about
    TARGET_CTAS CTAs cover the (row, KV head) pairs, with no empty split."""
    n = max(1, min(-(-t_len // SPLIT_MIN),
                   -(-TARGET_CTAS // max(1, rows * kv_heads))))
    per = -(-t_len // n)
    return -(-t_len // per), per


def visit_plan(n_split: int, split_len: int, t_len: int, length: int,
               head_dim: int) -> dict:
    """The positions each (split, warp, lane group) visits, as the kernel
    walks them for a row of ``length`` valid positions (all ``t_len`` when
    length <= 0, the masked row): {(split, warp, group): [positions]}.
    Every split, including one that starts past the length, is a key."""
    lp = 1
    while lp * 8 < head_dim:
        lp *= 2
    ppw = 32 // lp
    n = t_len if length <= 0 else min(length, t_len)
    per_warp = POSITIONS_PER_LANE_GROUP * ppw
    out = {}
    for s in range(n_split):
        t0, t1 = s * split_len, min((s + 1) * split_len, n)
        for w in range(WARPS):
            for grp in range(ppw):
                seen = out.setdefault((s, w, grp), [])
                for base in range(t0 + w * per_warp, t1, WARPS * per_warp):
                    seen += [t for u in range(POSITIONS_PER_LANE_GROUP)
                             if (t := base + u * ppw + grp) < t1]
    return out


_counters: dict = {}


def _split_buffers(name, q, b, hkv, g, hd, t_len):
    """The split plan and, with more than one split, the workspace (from
    the caching allocator, uninitialised) and the arrival counters.  The
    counters start at zero and the kernel's last CTA of each (row, KV
    head) sets its counter back to zero, so no call clears them.  They are
    kept per (device, stream): two streams running the kernel at once
    would otherwise count each other's CTAs; and per size, never freed, so
    a CUDA graph that captured their address stays valid."""
    n_split, per = split_plan(t_len, b, hkv)
    if b > MAX_ROWS:
        raise ValueError(f"{name}: {b} rows exceed the kernel's grid "
                         f"({MAX_ROWS})")
    if n_split == 1:
        return n_split, per, None, None
    ws = torch.empty(b * hkv * n_split * g * (hd + 2), dtype=torch.float32,
                     device=q.device)
    key = (q.device.index, build.stream_ptr(q), b * hkv)
    cnt = _counters.get(key)
    if cnt is None:
        cnt = torch.zeros(b * hkv, dtype=torch.int32, device=q.device)
        _counters[key] = cnt
    return n_split, per, ws, cnt


def _split_args(split):
    n_split, per, ws, cnt = split
    return (n_split, per, None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr())


def decode_attention(q, k, v, kv_len=None, *, scale: float, window: int = 0,
                     softcap: float = 0.0):
    """q: (B,HQ,hd); k/v: (B,HKV,T,hd); returns (B,HQ,hd).

    ``kv_len``: None (all T positions valid), an int for every row, or a
    (B,) int32 tensor of per-row lengths.  K and V may be any strided views
    with unit stride on hd: the engine passes ``cache.transpose(1, 2)`` of
    its (B,T,HKV,hd) cache, and the kernel reads it in place.
    ``softcap`` > 0 caps the scaled scores (``cap * tanh(s / cap)``);
    ``window`` > 0 attends only the positions > kv_len - 1 - window of each
    row (a sliding-window layer: the query sits at kv_len - 1, also where
    kv_len exceeds T; a row left with no position softmaxes uniformly, as
    one with kv_len 0 does).
    """
    build.require_placed("decode_attention", q)
    per_row = isinstance(kv_len, torch.Tensor)
    return _decode_op._opoverload(q, k, v, kv_len if per_row else None,
                      -1 if kv_len is None or per_row else int(kv_len),
                      float(scale), _window(window), float(softcap))


def _window(window) -> int:
    window = int(window)
    if window < 0:
        raise ValueError(f"decode attention: window must be >= 0, got "
                         f"{window}")
    return window


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cpu")
def _decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: Optional[torch.Tensor], kv_len_int: int,
               scale: float, window: int, softcap: float) -> torch.Tensor:
    lens = kv_len if kv_len is not None else (
        None if kv_len_int < 0 else kv_len_int)
    return decode_attention_ref(q, k, v, lens, scale=scale, window=window,
                                softcap=softcap).contiguous()


@_decode_op.register_kernel("cuda")
def _decode_launch(q, k, v, kv_len, kv_len_int, scale, window, softcap):
    per_row = kv_len is not None
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
    scalar = t if kv_len_int < 0 or per_row else kv_len_int
    split = _split_buffers("decode_attention", q, b, hkv, hq // hkv, hd, t)
    fn = build.function("decode_attention_launch", _ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              kv_len.data_ptr() if per_row else None, scalar,
              b, hq, hkv, t, hd, scale, window, softcap,
              q.stride(0), q.stride(1), k.stride(0), k.stride(1),
              k.stride(2), v.stride(0), v.stride(1), v.stride(2),
              out.stride(0), out.stride(1), *_split_args(split),
              build.dtype_code(q), build.stream_ptr(q))
    build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


@_decode_op.register_fake
def _decode_fake(q, k, v, kv_len, kv_len_int, scale, window, softcap):
    return q.new_empty(q.shape)


def _decode_costs(q, k, v, kv_len, kv_len_int, scale, window,
                  softcap) -> tuple:
    """(flops, bytes): two products over every cached position of each
    query head, and q, K, V and the output moved once."""
    b, hq, hd = q.shape
    t = k.shape[2]
    return 4.0 * b * hq * t * hd, float(build.nbytes(q, k, v, kv_len)
                                        + build.nbytes(q))


decode_attention.launches = 0
decode_attention.op = _decode_op._opoverload
decode_attention.costs = _decode_costs


def _check_paged(name, q, k_pages, v_pages, block_tables, kv_lens,
                 scales=()):
    """Raise unless the paged kernels take these tensors as they are."""
    build.require_cuda(name, q, k_pages, v_pages, block_tables, kv_lens,
                       *scales)
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be (B,HQ,hd) "
                         f"and pages {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} one (P,bs,HKV,hd) shape")
    b, hq, hd = q.shape
    _, _, hkv, hd_p = k_pages.shape
    if hd_p != hd or hq % hkv or hq // hkv > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: needs pages' hd == q's, HQ % HKV == 0, "
                         f"HQ/HKV <= {MAX_GROUP}, hd <= {MAX_HEAD_DIM}; got "
                         f"q {tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    if q.stride(2) != 1 or k_pages.stride(3) != 1 or v_pages.stride(3) != 1:
        raise ValueError(f"{name}: head_dim must have unit stride")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.dtype != torch.int32
            or block_tables.stride(1) != 1):
        raise ValueError(f"{name}: block_tables must be (B, NB) int32 with "
                         f"unit stride on NB, got {tuple(block_tables.shape)}"
                         f" {block_tables.dtype}")
    if (kv_lens.shape != (b,) or kv_lens.dtype != torch.int32
            or not kv_lens.is_contiguous()):
        raise ValueError(f"{name}: kv_lens must be a contiguous (B,) int32 "
                         "tensor")
    for s in scales:
        if s.shape != k_pages.shape[:3] or s.dtype != torch.float32:
            raise ValueError(f"{name}: scales must be (P,bs,HKV) float32, "
                             f"got {tuple(s.shape)} {s.dtype}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_lens, *,
                           scale: float, k_scale=None, v_scale=None,
                           window: int = 0, softcap: float = 0.0):
    """Decode attention through a block-table paged KV pool.

    q: (B,HQ,hd); k_pages/v_pages: (P,bs,HKV,hd), read in place through
    strides (any view with unit stride on hd); block_tables: (B,NB) int32
    page ids (entries past a row's length may be any value: they are
    clamped into the pool and masked); kv_lens: (B,) int32 valid tokens,
    capped at NB*bs.  Returns (B,HQ,hd) in q's dtype.

    With ``k_scale``/``v_scale`` ((P,bs,HKV) f32) the pages are int8
    payloads and the call goes to ``paged_decode_attention_quant``.
    ``window`` and ``softcap`` as in ``decode_attention``.
    """
    if k_scale is not None or v_scale is not None:
        return paged_decode_attention_quant(q, k_pages, v_pages, k_scale,
                                            v_scale, block_tables, kv_lens,
                                            scale=scale, window=window,
                                            softcap=softcap)
    build.require_placed("paged_decode_attention", q)
    return _paged_op._opoverload(q, k_pages, v_pages, block_tables,
                                 kv_lens, float(scale), _window(window),
                                 float(softcap))


@torch.library.custom_op("repro_torch::paged_decode_attention",
                         mutates_args=(), device_types="cpu")
def _paged_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              block_tables: torch.Tensor, kv_lens: torch.Tensor,
              scale: float, window: int, softcap: float) -> torch.Tensor:
    return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                      kv_lens, scale=scale, window=window,
                                      softcap=softcap).contiguous()


@_paged_op.register_kernel("cuda")
def _paged_launch(q, k_pages, v_pages, block_tables, kv_lens, scale, window,
                  softcap):
    _check_paged("paged_decode_attention", q, k_pages, v_pages,
                 block_tables, kv_lens)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and pages must share "
                         "one dtype")
    b, hq, hd = q.shape
    n_pages, bs, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    out = torch.empty((b, hq, hd), dtype=q.dtype, device=q.device)
    split = _split_buffers("paged_decode_attention", q, b, hkv, hq // hkv,
                           hd, nb * bs)
    fn = build.function("paged_decode_attention_launch", _PAGED_ARGS)
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              out.data_ptr(), block_tables.data_ptr(), kv_lens.data_ptr(),
              b, hq, hkv, hd, n_pages, bs, nb, scale, window, softcap,
              q.stride(0), q.stride(1), *k_pages.stride()[:3],
              *v_pages.stride()[:3], out.stride(0), out.stride(1),
              block_tables.stride(0), *_split_args(split),
              build.dtype_code(q), build.stream_ptr(q))
    build.check(code, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


@_paged_op.register_fake
def _paged_fake(q, k_pages, v_pages, block_tables, kv_lens, scale, window,
                softcap):
    return q.new_empty(q.shape)


def _paged_bytes(q, pages, block_tables, kv_lens, per_position) -> float:
    """Bytes a paged call moves: q, the table, the lengths, the output and
    each row's positions (a full table's worth) of every page operand."""
    b, nb = block_tables.shape
    bs = pages[0].shape[1]
    return float(2 * build.nbytes(q) + build.nbytes(block_tables, kv_lens)
                 + b * nb * bs * per_position)


def _paged_costs(q, k_pages, v_pages, block_tables, kv_lens, scale, window,
                 softcap):
    b, hq, hd = q.shape
    nb, bs = block_tables.shape[1], k_pages.shape[1]
    per = (k_pages[0, 0].numel() * k_pages.element_size()
           + v_pages[0, 0].numel() * v_pages.element_size())
    return (4.0 * b * hq * nb * bs * hd,
            _paged_bytes(q, (k_pages,), block_tables, kv_lens, per))


def paged_decode_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                 block_tables, kv_lens, *, scale: float,
                                 window: int = 0, softcap: float = 0.0):
    """``paged_decode_attention`` over an int8 pool: k_pages/v_pages
    (P,bs,HKV,hd) int8 and k_scale/v_scale (P,bs,HKV) f32, dequantized in
    registers inside the kernel.  q: f32 or bf16.  ``window`` and
    ``softcap`` as in ``decode_attention``."""
    if k_scale is None or v_scale is None:
        raise ValueError("paged_decode_attention_quant: needs both k_scale "
                         "and v_scale")
    build.require_placed("paged_decode_attention_quant", q)
    return _quant_op._opoverload(q, k_pages, v_pages, k_scale, v_scale,
                                 block_tables, kv_lens, float(scale),
                                 _window(window), float(softcap))


@torch.library.custom_op("repro_torch::paged_decode_attention_quant",
                         mutates_args=(), device_types="cpu")
def _quant_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              k_scale: torch.Tensor, v_scale: torch.Tensor,
              block_tables: torch.Tensor, kv_lens: torch.Tensor,
              scale: float, window: int, softcap: float) -> torch.Tensor:
    return paged_decode_attention_quant_ref(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, kv_lens,
        scale=scale, window=window, softcap=softcap).contiguous()


@_quant_op.register_kernel("cuda")
def _quant_launch(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                  kv_lens, scale, window, softcap):
    name = "paged_decode_attention_quant"
    _check_paged(name, q, k_pages, v_pages, block_tables, kv_lens,
                 (k_scale, v_scale))
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(f"{name}: pages must be int8, got {k_pages.dtype}")
    b, hq, hd = q.shape
    n_pages, bs, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    out = torch.empty((b, hq, hd), dtype=q.dtype, device=q.device)
    split = _split_buffers(name, q, b, hkv, hq // hkv, hd, nb * bs)
    fn = build.function("paged_decode_attention_quant_launch",
                        _PAGED_QUANT_ARGS)
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
              block_tables.data_ptr(), kv_lens.data_ptr(),
              b, hq, hkv, hd, n_pages, bs, nb, scale, window, softcap,
              q.stride(0), q.stride(1), *k_pages.stride()[:3],
              *v_pages.stride()[:3], *k_scale.stride(), *v_scale.stride(),
              out.stride(0), out.stride(1), block_tables.stride(0),
              *_split_args(split), build.dtype_code(q), build.stream_ptr(q))
    build.check(code, name)
    paged_decode_attention_quant.launches += 1
    return out


@_quant_op.register_fake
def _quant_fake(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                kv_lens, scale, window, softcap):
    return q.new_empty(q.shape)


def _quant_costs(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                 kv_lens, scale, window, softcap):
    b, hq, hd = q.shape
    nb, bs = block_tables.shape[1], k_pages.shape[1]
    per = sum(t[0, 0].numel() * t.element_size()
              for t in (k_pages, v_pages, k_scale, v_scale))
    return (4.0 * b * hq * nb * bs * hd,
            _paged_bytes(q, (k_pages,), block_tables, kv_lens, per))


paged_decode_attention.launches = 0
paged_decode_attention.op = _paged_op._opoverload
paged_decode_attention.costs = _paged_costs
paged_decode_attention_quant.launches = 0
paged_decode_attention_quant.op = _quant_op._opoverload
paged_decode_attention_quant.costs = _quant_costs
