"""Wrapper of the fused RMSNorm + projection CUDA kernel
(``csrc/rmsnorm_matmul.cu``).

The wrapper calls a ``torch.library`` custom op: its CPU implementation is
the plain version (``ref.py``), its CUDA implementation launches the kernel
or raises, and its fake implementation gives a tracer the outputs' shapes.
A trace expands the op into its plain version (``core/tracing.py``), as the
reference traces the unfused norm. ``rmsnorm_matmul.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused.rmsnorm_matmul.ref import rmsnorm_matmul_ref

_ARGS = [build.P, build.P, build.P, build.P, build.P, build.I, build.I,
         build.I, build.I, build.I, build.F, build.I, build.P]
COLS = 8             # output columns per CTA (csrc/rmsnorm_matmul.cu RM_COLS)
ROWS = 16            # rows per CTA; more rows take more CTAs along grid.y
GROUP_ROWS = 8       # rows per register group of the FMA kernel
THREADS = 256
WARPS = THREADS // 32
K_CHUNK = 1024       # W rows one CTA holds at once: THREADS x 4 a thread
MAX_GRID_Y = 65535


def tile_plan(n: int, d: int, f: int) -> dict:
    """The kernel's launch plan for x (n, d) @ W (d, f): grid (column tiles
    of COLS, row blocks of ROWS) and K chunks.  The C entry checks the grid
    it is given against the same rule."""
    return dict(grid=(-(-f // COLS), -(-n // ROWS)),
                k_chunks=-(-d // K_CHUNK))


def plan_cover(n: int, d: int, f: int, mma: bool = False):
    """What each CTA of ``tile_plan`` computes, as the FMA kernel (f32 and
    unaligned bf16) or with ``mma`` the bf16 tensor-core kernel indexes it:
    yields ((row groups, column range), [k range of each (chunk, thread)]
    or, with ``mma``, of each (chunk, warp, 16-row step)) per CTA, so that
    a test can check that every (row, column) of the product is one CTA's
    and gets every k once."""
    p = tile_plan(n, d, f)
    gx, gy = p["grid"]
    group = ROWS if mma else GROUP_ROWS
    if mma:
        steps = K_CHUNK // 16 // WARPS
        ks = [range(k, min(k + 16, d))
              for c in range(p["k_chunks"]) for w in range(WARPS)
              for s in range(steps)
              if (k := c * K_CHUNK + (w * steps + s) * 16) < d]
    else:
        ks = [range(c * K_CHUNK + t, min(d, (c + 1) * K_CHUNK), THREADS)
              for c in range(p["k_chunks"]) for t in range(THREADS)]
        assert all(len(k) <= K_CHUNK // THREADS for k in ks)
    for by in range(gy):
        rows = range(by * ROWS, min(n, (by + 1) * ROWS))
        groups = [range(g, min(rows.stop, g + group))
                  for g in range(rows.start, rows.stop, group)]
        for bx in range(gx):
            cols = range(bx * COLS, min(f, (bx + 1) * COLS))
            yield (groups, cols), ks


def rmsnorm_matmul(x, weight, w_proj, *, eps: float = 1e-5):
    """x: (..., D), weight: (D,), w_proj: (D, F) ->
    (proj (..., F) in w_proj's dtype, normed (..., D) in x's dtype)."""
    build.require_placed("rmsnorm_matmul", x)
    proj, normed = _op._opoverload(x, weight, w_proj, float(eps))
    return proj, normed


@torch.library.custom_op("repro_torch::rmsnorm_matmul", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, weight: torch.Tensor, w_proj: torch.Tensor,
        eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    return rmsnorm_matmul_ref(x, weight, w_proj, eps)


@_op.register_kernel("cuda")
def _launch(x, weight, w_proj, eps):
    build.require_cuda("rmsnorm_matmul", x, weight, w_proj)
    d = x.shape[-1]
    if weight.shape != (d,) or w_proj.dim() != 2 or w_proj.shape[0] != d:
        raise ValueError(f"rmsnorm_matmul: x (..., {d}) needs weight ({d},) "
                         f"and w_proj ({d}, F), got {tuple(weight.shape)} "
                         f"and {tuple(w_proj.shape)}")
    if weight.dtype != x.dtype or w_proj.dtype != x.dtype:
        raise ValueError("rmsnorm_matmul: all tensors must share one dtype")
    if not (x.is_contiguous() and weight.is_contiguous()
            and w_proj.is_contiguous()):
        raise ValueError("rmsnorm_matmul: tensors must be contiguous")
    f = w_proj.shape[1]
    n = x.numel() // d
    plan = tile_plan(n, d, f)
    if plan["grid"][1] > MAX_GRID_Y:
        raise ValueError(f"rmsnorm_matmul: {n} rows exceed the kernel's "
                         f"grid ({ROWS * MAX_GRID_Y} rows)")
    proj, normed = _fake(x, weight, w_proj, eps)
    fn = build.function("rmsnorm_matmul_launch", _ARGS)
    code = fn(x.data_ptr(), weight.data_ptr(), w_proj.data_ptr(),
              proj.data_ptr(), normed.data_ptr(), n, d, f, *plan["grid"], eps,
              build.dtype_code(x), build.stream_ptr(x))
    build.check(code, "rmsnorm_matmul")
    rmsnorm_matmul.launches += 1
    return proj, normed


@_op.register_fake
def _fake(x, weight, w_proj, eps):
    return (x.new_empty(x.shape[:-1] + (w_proj.shape[1],),
                        dtype=w_proj.dtype), torch.empty_like(x))


def _costs(x, weight, w_proj, eps) -> tuple:
    """(flops, bytes): the product's 2 N D F, and x, the scale, W and both
    outputs moved once."""
    d, f = w_proj.shape
    n = x.numel() // d
    return 2.0 * n * d * f, float(build.nbytes(x, weight, w_proj, x)
                                  + n * f * w_proj.element_size())


rmsnorm_matmul.launches = 0
rmsnorm_matmul.op = _op._opoverload
rmsnorm_matmul.costs = _costs
