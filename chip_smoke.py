"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before a result is printed):

  1. build the hand-written kernels from ``src/repro_torch/csrc`` with nvcc
     for sm_90a (no kernel may spill registers), and time an empty kernel's
     launch;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (SmolLM-360M, max_batch 4, max_len 128, 16-token prefill
     bucket; the norms at both the decode rows (4 x 1) and a slot's
     prefill rows (1 x 16)) in f32 and bf16, and time kernel, plain
     version and, where one PyTorch call computes the same function, that
     call.  The paged kernels run at the paged path's shapes (block size
     16, 8 blocks per row, a 32-page bf16 pool and a 60-page int8 pool,
     permuted pages and sentinel table entries), and the bf16 one is also
     held against the contiguous kernel on the same logical KV;
     ``flash_attention`` also at causal prefills of S = T = 128 and 1024
     (``[t128]``, ``[t1024]``), each beside SDPA; ``decode_attention`` and
     ``paged_decode_attention`` also over a 1024-position cache
     (``[t1024]``: lengths 1024/768/512/256, block 16, 64 blocks a row, the
     contiguous one beside SDPA with a mask); ``rmsnorm_matmul`` beside the
     unfused pair it replaces (``F.rms_norm`` then ``torch.matmul``).  At
     the new configs' shapes too (``dense_cases``): the three decode
     entries at Gemma-2's (32/16 heads of 128, window 16, softcap 50),
     Llama-3.2-1B's, InternLM2's and CodeQwen's decode shapes, and at
     ``[gemma2_t1024]`` (window 256) beside SDPA with the windowed mask;
     ``flash_attention`` non-causal at BERT's prefill (B 4, 12 heads of
     64, S = T = 512) beside SDPA; the norms at D 2048, 4096, 4608 and
     6144;
  3. full-width SmolLM-360M logits in f32, kernels against plain
     versions, for a prefill and batched decode steps; then the paged
     path (a chunked prefill in chunks of 8 and the same decode steps)
     against the contiguous path, both through the kernels;
  4. the first main path: ``repro_torch.launch.serve`` serving full-width
     SmolLM-360M in bf16 on the contiguous cache (8 requests, max_batch
     4), with every kernel's launch count reset just before and read just
     after;
  5. a profiler trace of decode steps (device time by kernel, the
     hand-written kernels' time per step, host ops by self time), then of a
     slot's prefill (the hand-written kernels' time per prefill);
  6. the second main path: the same serve command with ``--cache paged
     --block-size 16``, the launches checked per decode step and per
     prefill chunk, then a trace of its decode step as in phase 5;
  7. the third: ``ServeEngine`` on full-width SmolLM-360M with an int8
     paged pool too small for the load (prefix sharing, chunked prefill,
     host offload), which must preempt, offload, restore and share and
     serve the tokens the same requests get from a pool that never
     preempts, then a trace of its decode step;
  8. full-width RWKV-6 3B logits in f32 (after the SmolLM engines are
     freed), kernels against plain versions, for a 12-token prefill and 3
     batched decode steps at batch 4;
  9. the fourth main path: ``repro_torch.launch.serve --arch rwkv6-3b`` in
     bf16 (wkv6 and the legacy rmsnorm kernel), launches checked per decode
     step and per prefill, served first tokens against the plain bf16
     forward; then an f32 engine at full width and 2 layers whose whole
     token streams must equal an unpadded incremental forward's (the
     engine prefills a recurrent stack without bucket padding);
 10. a trace of the RWKV-6 decode step and prefill, as in phase 5;
 11. the four main paths again under ``--plan jit`` (the serve default:
     each step one CUDA graph replay), each beside its ``--plan eager`` run
     above: the same tokens request for request except where the plain
     versions' logits of the two tokens lie within LOGIT_TOL_BF16 (eager
     runs the norms as their plain bf16 versions, other arithmetic; each
     such tie is printed), one dispatch per decode step, the path's
     launches per decode step and per prefill; then per cell and plan the
     decode step's wall, host and device-busy time, idle share, tok/s,
     TTFT, ITL and the graphs captured (count, seconds, pool memory).
     The launch counts of these runs (reset just before each, read just
     after) are the main paths' launches in the ``kernels`` line;
 12. the launch-plan runtime: SmolLM contiguous under ``whole_graph``,
     ``chain``, ``auto`` and ``fused``, and SmolLM paged bf16, int8 under
     pool pressure and RWKV-6 3B under ``auto`` and ``fused`` (8 requests,
     16 new tokens): per row the dispatches and hand-written launches per
     decode step and per prefill, the fused rule hits per call, the
     modeled TKLQT (``Intel+H100``), the decode step traced as in phase 5,
     tok/s, TTFT, ITL, the graphs and the trace (nodes, seconds).  Checks:
     ``fused`` tokens equal ``jit``'s request for request in every cell;
     rule hits per SmolLM call rmsnorm_matmul 32, residual_rmsnorm 32,
     rmsnorm 1 (RWKV-6: 2L+1 windows); launches per decode step equal
     under whole_graph, chain and auto; dispatches per decode step eager >
     chain >= auto >= whole_graph = 1, with chain = auto only where auto
     chose a chain.  Then the measured Eq. 1 timeline
     of one SmolLM contiguous decode step at batch 1, 2 and 4 under
     ``eager`` and ``fused``: ``KernelEvent``s from ``torch.profiler``,
     each kernel joined to the runtime call that launched it by its
     correlation id (a kernel of a graph replay takes the
     ``cudaGraphLaunch``; a profile whose clocks put a kernel before its
     call is discarded and taken again, up to 12 profiles; the median of
     the (up to three) kept, or "not measured" if none is left), fed to
     ``core.metrics.report`` (TKLQT, AKD, IL, GPU idle) beside the
     modeled TKLQT of the same trace, and
     ``core.boundedness.find_inflection`` over the measured eager curve;
 13. Llama-3.2-1B, the paper's headline model, at full width and depth
     (16 layers, random bf16 weights): f32 logits kernels against plain
     versions (a prefill and 3 decode steps); ``serve --arch llama-3.2-1b``
     under eager and jit on the contiguous cache and with ``--cache paged
     --block-size 16``, checked and traced as in phase 11 (launches per
     decode step 16 / 16 / 17, one dispatch under jit, jit's tokens
     against eager's); then ``--plan fused`` on the contiguous cache (its
     tokens equal jit's, rule hits 16 / 16 / 1 per call);
 14. the other six: InternLM2-20B, CodeQwen1.5-7B (qkv biases drawn
     non-zero) and Gemma-2-27B (one local, one global layer) at full
     width and 2 layers, GPT-2 at full depth: f32 logits kernels against
     plain versions (Gemma-2 also with its window cut to 8, so that it
     bites), then an engine under eager and jit, jit's tokens against
     eager's; BERT and XLM-R at full depth: one f32 non-causal forward of
     4 x 512 tokens, kernels against plain versions.  Each model is freed
     before the next is built.

Phases 4, 6, 7 and 9 serve with ``--plan eager`` (``plan="eager"``): one
dispatch a node of the traced step, whose norms are their plain versions,
so only the attention kernels (or ``wkv6``) launch there; their traces (5,
6, 7, 10) are those of the eager step.

Phase 2 ends with the host time of one ``decode_attention`` call through
its wrapper, its op overload and its CUDA implementation called directly:
what the ``torch.library`` dispatcher adds to a launch.

Phase 2 also holds the RWKV-6 path's two kernels at its shapes: the norm
at (4, 1, 2560) and (1, 12, 2560) with and without a residual in f32 and
bf16, WKV6 (f32) at decode (B 4, T 1), a 12-token prefill, 64 and 1024
steps in one launch (``[t64]``, ``[t1024]``: B 1, H 40, hd 64) and the
reference's extreme-decay case, which must stay finite.

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It needs the repository
(it adds ``src`` to ``sys.path``) and a CUDA device, and imports nothing of
JAX.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
LOGIT_TOL_F32 = 1e-3               # full model, f32, other summation order
LOGIT_TOL_BF16 = 0.25              # full model, bf16 rounding at other points
ARCH, MAX_BATCH, MAX_LEN, BUCKET, N_REQ = "smollm-360m", 4, 128, 16, 8
RWKV_ARCH, PROMPT = "rwkv6-3b", 12   # the serve CLI's prompts: 12 tokens
BLOCK, CHUNK = 16, 8               # paged path: tokens per page, per chunk
POOL_PAGES = {"bf16": 32, "int8": 60}   # default_num_blocks at hd 64
KERNEL_INFO = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:228"),
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:211"),
    "paged_decode_attention_quant": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:170"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:91"),
    "residual_rmsnorm": ("src/repro_torch/csrc/residual_rmsnorm.cu",
                         "src/repro/kernels/fused/residual_rmsnorm/"
                         "kernel.py:59"),
    "rmsnorm_matmul": ("src/repro_torch/csrc/rmsnorm_matmul.cu",
                       "src/repro/kernels/fused/rmsnorm_matmul/kernel.py:53"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:36"),
    "wkv6": ("src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:77"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def setup():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repository")
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


torch = setup()
import numpy as np                                         # noqa: E402
import torch.nn.functional as F                            # noqa: E402

from repro_torch import kernels                            # noqa: E402
from repro_torch.configs import get_config                 # noqa: E402
from repro_torch.core.boundedness import find_inflection   # noqa: E402
from repro_torch.core.device_model import KernelEvent      # noqa: E402
from repro_torch.core.metrics import report as skip_report  # noqa: E402
from repro_torch.runtime import Planner                    # noqa: E402
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.inference.engine import Request, ServeEngine  # noqa: E402
from repro_torch.inference.kv_quant import quantize_kv     # noqa: E402
from repro_torch.kernels.decode_attention.ops import _decode_launch  # noqa: E402,E501
from repro_torch.kernels.decode_attention.ref import (     # noqa: E402
    decode_attention_ref, paged_decode_attention_quant_ref,
    paged_decode_attention_ref)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused.residual_rmsnorm.ref import \
    residual_rmsnorm_ref                                   # noqa: E402
from repro_torch.kernels.fused.rmsnorm_matmul.ref import \
    rmsnorm_matmul_ref                                     # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref    # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_oracle, wkv6_ref  # noqa: E402
from repro_torch.launch import serve                       # noqa: E402
from repro_torch.models import (forward, init_params,      # noqa: E402
                                is_recurrent, make_cache, make_paged_cache)

DEV = torch.device("cuda", 0)
PLAINS = {"decode_attention": decode_attention_ref,
          "flash_attention": attention_ref,
          "paged_decode_attention": paged_decode_attention_ref,
          "paged_decode_attention_quant": paged_decode_attention_quant_ref,
          "residual_rmsnorm": residual_rmsnorm_ref,
          "rmsnorm_matmul": rmsnorm_matmul_ref,
          "rmsnorm": rmsnorm_ref,
          "wkv6": wkv6_ref}


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions (on the card)."""
    saved = {name: getattr(kernels, name) for name in PLAINS}
    try:
        for name, fn in PLAINS.items():
            setattr(kernels, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


# ------------------------------------------------------------------ timing
_FLUSH = None


def time_ms(fn, iters: int = 50) -> tuple:
    """(device ms, host ms) of one call.

    Device: the median over ``iters`` calls, each with the L2 flushed first
    (weights and caches are cold when a 32-layer step reaches them) and the
    stream held busy for ~1 ms, so the call is fully enqueued before the
    device reaches it and the CUDA events around it time the device alone.
    Host: the mean enqueue time of ``4 * iters`` calls back to back (the
    wrapper's checks and launches, or the plain version's eager ops)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    dev = []
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4 * iters):
        fn()
    host = (time.perf_counter() - t0) / (4 * iters) * 1e3
    torch.cuda.synchronize()
    return float(np.median(dev)), host


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    """(least time in ms, what bounds it) on an H100 SXM at 700 W."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def randn(shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(DEV, dtype)


def max_err(out, ref) -> float:
    torch.cuda.synchronize()
    if isinstance(out, tuple):
        return max(max_err(o, r) for o, r in zip(out, ref))
    return (out.float() - ref.float()).abs().max().item()


def rel_bound(ref, dtype) -> float:
    if isinstance(ref, tuple):
        return min(rel_bound(r, dtype) for r in ref)
    return TOL[str(dtype)] * max(1.0, ref.float().abs().max().item())


# ------------------------------------------------------------------ phase 1
def phase_build() -> None:
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    secs = time.perf_counter() - t0
    built = build.build_seconds is not None
    print(f"phase 1: kernels {'built' if built else 'found'} in {secs:.2f} s "
          f"({path.name}, sm_90a)")
    spills = 0
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found:
            spills += int(found.group(1)) + int(found.group(2))
    if spills:
        fail(f"the kernels spill {spills} bytes of registers (build.log)")
    stream = torch.cuda.current_stream(DEV).cuda_stream
    for _ in range(100):
        build.null_launch(stream)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        build.null_launch(stream)
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    dev_us = time_ms(lambda: build.null_launch(stream), iters=200)[0] * 1e3
    print(f"  empty kernel: host launch {host_us:.2f} us/launch "
          f"(ctypes call + cudaLaunchKernel, back to back), device "
          f"{dev_us:.2f} us between the events around it")


# ------------------------------------------------------------------ phase 2
def paged_table(lens, n_pages, seed, nb=MAX_LEN // BLOCK) -> torch.Tensor:
    """(B, nb) int32 block table: each row's pages drawn from a permutation
    of the pool, entries past a row's length the sentinel ``n_pages``, as
    the engine builds them."""
    perm = np.random.default_rng(seed).permutation(n_pages)
    table = np.full((len(lens), nb), n_pages, np.int32)
    nxt = 0
    for row, n in enumerate(lens):
        for i in range(-(-n // BLOCK)):
            table[row, i] = perm[nxt]
            nxt += 1
    return torch.from_numpy(table).to(DEV)


def main_path_cases(cfg, dtype):
    """Inputs of each kernel at the shapes the main path gives it, with the
    bytes and flops the call needs on these inputs.  A key ``name[variant]``
    is another call of kernel ``name``: without a residual, or at a slot's
    prefill rows (1, BUCKET, d), where ``rmsnorm_matmul`` runs two row
    tiles.  The paged kernels read the valid pages of each row; the bf16
    one is also held against the contiguous kernel on the same logical
    KV (``contiguous``)."""
    b, d, hq, hkv, hd = MAX_BATCH, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    scale = hd ** -0.5
    lens = torch.tensor([28, 21, 17, 13], dtype=torch.int32, device=DEV)
    n_kv = int(lens.sum())
    cache_k = randn((b, MAX_LEN, hkv, hd), dtype, 1)
    cache_v = randn((b, MAX_LEN, hkv, hd), dtype, 2)
    q_dec = randn((b, hq, hd), dtype, 3)
    kt, vt = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    mask = (torch.arange(MAX_LEN, device=DEV)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    q_pre = randn((1, BUCKET, hq, hd), dtype, 4).transpose(1, 2)
    k_pre = randn((1, BUCKET, hkv, hd), dtype, 5).transpose(1, 2)
    v_pre = randn((1, BUCKET, hkv, hd), dtype, 6).transpose(1, 2)
    x = randn((b, 1, d), dtype, 7)
    r = randn((b, 1, d), dtype, 8)
    w = randn((d,), dtype, 9) + 1.0
    wq = randn((d, hq * hd), dtype, 10, scale=0.02)
    xp = randn((1, BUCKET, d), dtype, 11)
    rp = randn((1, BUCKET, d), dtype, 12)
    pairs = BUCKET * (BUCKET + 1) // 2
    f = hq * hd
    nb = MAX_LEN // BLOCK
    lens_host = lens.tolist()
    bt = paged_table(lens_host, POOL_PAGES["bf16"], 13)
    kp = randn((POOL_PAGES["bf16"], BLOCK, hkv, hd), dtype, 14)
    vp = randn((POOL_PAGES["bf16"], BLOCK, hkv, hd), dtype, 15)
    # the same logical KV as a contiguous (B, T, HKV, hd) cache
    logical = bt.long().clamp(0, POOL_PAGES["bf16"] - 1)
    ck = kp[logical].reshape(b, nb * BLOCK, hkv, hd)
    cv = vp[logical].reshape(b, nb * BLOCK, hkv, hd)
    bt8 = paged_table(lens_host, POOL_PAGES["int8"], 16)
    kq, ks = quantize_kv(randn((POOL_PAGES["int8"], BLOCK, hkv, hd),
                               torch.float32, 17))
    vq, vs = quantize_kv(randn((POOL_PAGES["int8"], BLOCK, hkv, hd),
                               torch.float32, 18))
    table_bytes = 4 * b * nb + 4 * b
    return {
        "paged_decode_attention": dict(
            call=lambda: kernels.paged_decode_attention(q_dec, kp, vp, bt,
                                                        lens, scale=scale),
            plain=lambda: paged_decode_attention_ref(q_dec, kp, vp, bt, lens,
                                                     scale=scale),
            contiguous=lambda: kernels.decode_attention(
                q_dec, ck.transpose(1, 2), cv.transpose(1, 2), lens,
                scale=scale),
            library=None,
            bytes=(2 * b * hq * hd + 2 * n_kv * hkv * hd) * es + table_bytes,
            flops=4 * n_kv * hq * hd),
        "paged_decode_attention_quant": dict(
            call=lambda: kernels.paged_decode_attention_quant(
                q_dec, kq, vq, ks, vs, bt8, lens, scale=scale),
            plain=lambda: paged_decode_attention_quant_ref(
                q_dec, kq, vq, ks, vs, bt8, lens, scale=scale),
            library=None,
            bytes=(2 * b * hq * hd * es + 2 * n_kv * hkv * (hd + 4)
                   + table_bytes),
            flops=4 * n_kv * hq * hd),
        "decode_attention": dict(
            call=lambda: kernels.decode_attention(q_dec, kt, vt, lens,
                                                  scale=scale),
            plain=lambda: decode_attention_ref(q_dec, kt, vt, lens,
                                               scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q_dec[:, :, None], kt, vt, attn_mask=mask, scale=scale,
                enable_gqa=True),
            bytes=(2 * b * hq * hd + 2 * n_kv * hkv * hd) * es + 4 * b,
            flops=4 * n_kv * hq * hd),
        "flash_attention": dict(
            call=lambda: kernels.flash_attention(q_pre, k_pre, v_pre,
                                                 scale=scale),
            plain=lambda: attention_ref(q_pre, k_pre, v_pre, scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q_pre, k_pre, v_pre, is_causal=True, scale=scale,
                enable_gqa=True),
            bytes=(2 * BUCKET * hq * hd + 2 * BUCKET * hkv * hd) * es,
            flops=4 * pairs * hq * hd),
        "residual_rmsnorm": dict(
            call=lambda: kernels.residual_rmsnorm(x, w, r),
            plain=lambda: residual_rmsnorm_ref(x, w, r),
            library=None,
            bytes=(4 * b * d + d) * es, flops=5 * b * d),
        "residual_rmsnorm[no_residual]": dict(
            call=lambda: kernels.residual_rmsnorm(x, w),
            plain=lambda: residual_rmsnorm_ref(x, w),
            library=lambda: F.rms_norm(x, (d,), w, eps=cfg.norm_eps),
            bytes=(2 * b * d + d) * es, flops=4 * b * d),
        "residual_rmsnorm[prefill]": dict(
            call=lambda: kernels.residual_rmsnorm(xp, w, rp),
            plain=lambda: residual_rmsnorm_ref(xp, w, rp),
            library=None,
            bytes=(4 * BUCKET * d + d) * es, flops=5 * BUCKET * d),
        "residual_rmsnorm[prefill_no_residual]": dict(
            call=lambda: kernels.residual_rmsnorm(xp, w),
            plain=lambda: residual_rmsnorm_ref(xp, w),
            library=lambda: F.rms_norm(xp, (d,), w, eps=cfg.norm_eps),
            bytes=(2 * BUCKET * d + d) * es, flops=4 * BUCKET * d),
        "rmsnorm_matmul": dict(
            call=lambda: kernels.rmsnorm_matmul(x, w, wq),
            plain=lambda: rmsnorm_matmul_ref(x, w, wq),
            library=None,
            unfused=lambda: torch.matmul(
                F.rms_norm(x, (d,), w, eps=cfg.norm_eps), wq),
            bytes=(2 * b * d + d + d * f + b * f) * es,
            flops=2 * b * d * f + 4 * b * d),
        "rmsnorm_matmul[prefill]": dict(
            call=lambda: kernels.rmsnorm_matmul(xp, w, wq),
            plain=lambda: rmsnorm_matmul_ref(xp, w, wq),
            library=None,
            unfused=lambda: torch.matmul(
                F.rms_norm(xp, (d,), w, eps=cfg.norm_eps), wq),
            bytes=(2 * BUCKET * d + d + d * f + BUCKET * f) * es,
            flops=2 * BUCKET * d * f + 4 * BUCKET * d),
    }


def flash_cases(cfg, dtype):
    """``flash_attention`` at longer causal prefills of the same heads: S =
    T = MAX_LEN (a prompt that fills the smoke's cache) and S = T = 1024,
    as ``name[t<S>]`` cases."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    cases = {}
    for n in (MAX_LEN, 1024):
        q, k, v = (randn((1, n, h, hd), dtype, seed).transpose(1, 2)
                   for h, seed in ((hq, 19), (hkv, 20), (hkv, 21)))
        cases[f"flash_attention[t{n}]"] = dict(
            call=lambda q=q, k=k, v=v: kernels.flash_attention(
                q, k, v, scale=hd ** -0.5),
            plain=lambda q=q, k=k, v=v: attention_ref(q, k, v,
                                                      scale=hd ** -0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=hd ** -0.5, enable_gqa=True),
            bytes=(2 * n * hq * hd + 2 * n * hkv * hd) * es,
            flops=4 * (n * (n + 1) // 2) * hq * hd)
    return cases


T_LONG = 1024                      # the [t1024] decode cases' cache
LONG_LENS = [1024, 768, 512, 256]


def decode_long_cases(cfg, dtype):
    """The decode kernels over a T_LONG-position cache, split over
    positions: ``decode_attention[t1024]`` (beside SDPA with a mask) and
    ``paged_decode_attention[t1024]`` (block 16, 64 blocks a row)."""
    b, hq, hkv, hd = MAX_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    scale = hd ** -0.5
    lens = torch.tensor(LONG_LENS, dtype=torch.int32, device=DEV)
    n_kv = sum(LONG_LENS)
    q = randn((b, hq, hd), dtype, 60)
    kt = randn((b, T_LONG, hkv, hd), dtype, 61).transpose(1, 2)
    vt = randn((b, T_LONG, hkv, hd), dtype, 62).transpose(1, 2)
    mask = (torch.arange(T_LONG, device=DEV)[None, :]
            < lens[:, None])[:, None, None, :]
    nb = T_LONG // BLOCK
    n_pages = b * nb
    bt = paged_table(LONG_LENS, n_pages, 63, nb)
    kp = randn((n_pages, BLOCK, hkv, hd), dtype, 64)
    vp = randn((n_pages, BLOCK, hkv, hd), dtype, 65)
    kv_bytes = (2 * b * hq * hd + 2 * n_kv * hkv * hd) * es
    return {
        "decode_attention[t1024]": dict(
            call=lambda: kernels.decode_attention(q, kt, vt, lens,
                                                  scale=scale),
            plain=lambda: decode_attention_ref(q, kt, vt, lens, scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, scale=scale,
                enable_gqa=True),
            bytes=kv_bytes + 4 * b, flops=4 * n_kv * hq * hd),
        "paged_decode_attention[t1024]": dict(
            call=lambda: kernels.paged_decode_attention(q, kp, vp, bt, lens,
                                                        scale=scale),
            plain=lambda: paged_decode_attention_ref(q, kp, vp, bt, lens,
                                                     scale=scale),
            library=None,
            bytes=kv_bytes + 4 * b * nb + 4 * b, flops=4 * n_kv * hq * hd),
    }


# the new configs' decode shapes: (HQ, HKV, hd, window, softcap, scale)
DENSE_DECODE = {"gemma2": (32, 16, 128, 16, 50.0, 0.0625),
                "llama": (32, 8, 64, 0, 0.0, 64 ** -0.5),
                "internlm2": (48, 8, 128, 0, 0.0, 128 ** -0.5),
                "codeqwen": (32, 32, 128, 0, 0.0, 128 ** -0.5)}
# the new configs' norm widths (D, F = HQ * hd): Llama, CodeQwen, Gemma-2,
# InternLM2
DENSE_WIDTHS = ((2048, 2048), (4096, 4096), (4608, 4096), (6144, 6144))
BERT_SEQ = 512                     # the paper's PAPER_SEQ


def decode_entry_cases(tag, hq, hkv, hd, window, cap, scale, dtype, lens,
                       t_len, seed):
    """The three decode entries at one config's decode shape (B 4, a
    ``t_len``-position cache, block 16, the pools holding each row's valid
    pages), keyed ``name[tag]``; without a softcap the contiguous one beside
    SDPA with the (windowed) length mask, which then computes the same
    function (no single library call caps the scores)."""
    b = len(lens)
    es = torch.tensor([], dtype=dtype).element_size()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    # the keys a row attends: its last ``window`` of ``len`` positions
    n_kv = sum(min(n, window) if window else n for n in lens)
    q = randn((b, hq, hd), dtype, seed)
    kt = randn((b, t_len, hkv, hd), dtype, seed + 1).transpose(1, 2)
    vt = randn((b, t_len, hkv, hd), dtype, seed + 2).transpose(1, 2)
    pos = torch.arange(t_len, device=DEV)[None, :]
    mask = pos < lens_t[:, None]
    if window:
        mask &= pos > lens_t[:, None] - 1 - window
    mask = mask[:, None, None, :]
    nb = t_len // BLOCK
    n_pages = sum(-(-n // BLOCK) for n in lens) + 3
    bt = paged_table(lens, n_pages, seed + 3, nb)
    kp = randn((n_pages, BLOCK, hkv, hd), dtype, seed + 4)
    vp = randn((n_pages, BLOCK, hkv, hd), dtype, seed + 5)
    kq, ks = quantize_kv(randn((n_pages, BLOCK, hkv, hd), torch.float32,
                               seed + 6))
    vq, vs = quantize_kv(randn((n_pages, BLOCK, hkv, hd), torch.float32,
                               seed + 7))
    opts = dict(scale=scale, window=window, softcap=cap)
    io_bytes = 2 * b * hq * hd * es
    table_bytes = 4 * b * nb + 4 * b
    flops = 4 * n_kv * hq * hd
    return {
        f"decode_attention[{tag}]": dict(
            call=lambda: kernels.decode_attention(q, kt, vt, lens_t, **opts),
            plain=lambda: decode_attention_ref(q, kt, vt, lens_t, **opts),
            library=(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, scale=scale,
                enable_gqa=True)) if not cap else None,
            bytes=io_bytes + 2 * n_kv * hkv * hd * es + 4 * b, flops=flops),
        f"paged_decode_attention[{tag}]": dict(
            call=lambda: kernels.paged_decode_attention(q, kp, vp, bt, lens_t,
                                                        **opts),
            plain=lambda: paged_decode_attention_ref(q, kp, vp, bt, lens_t,
                                                     **opts),
            library=None,
            bytes=io_bytes + 2 * n_kv * hkv * hd * es + table_bytes,
            flops=flops),
        f"paged_decode_attention_quant[{tag}]": dict(
            call=lambda: kernels.paged_decode_attention_quant(
                q, kq, vq, ks, vs, bt, lens_t, **opts),
            plain=lambda: paged_decode_attention_quant_ref(
                q, kq, vq, ks, vs, bt, lens_t, **opts),
            library=None,
            bytes=io_bytes + 2 * n_kv * hkv * (hd + 4) + table_bytes,
            flops=flops),
    }


def dense_cases(dtype):
    """The kernels at the new configs' shapes (keys ``name[tag]``): the
    decode entries at Gemma-2's (window 16, softcap 50, lengths
    28/21/17/13; and ``[gemma2_t1024]``: window 256, no softcap, lengths
    1024/768/512/256, beside SDPA with the windowed mask), Llama's,
    InternLM2's and CodeQwen's decode shapes (the contiguous entry beside
    SDPA with the length mask where there is no softcap); ``flash_attention``
    non-causal at BERT's prefill (B 4, 12 heads of 64, S = T = 512) beside
    SDPA; ``rmsnorm_matmul`` and ``residual_rmsnorm`` at the decode rows (4
    x 1) of D 2048, 4096, 4608 and 6144."""
    es = torch.tensor([], dtype=dtype).element_size()
    cases = {}
    for i, (tag, (hq, hkv, hd, window, cap, scale)) in enumerate(
            DENSE_DECODE.items()):
        cases.update(decode_entry_cases(tag, hq, hkv, hd, window, cap, scale,
                                        dtype, [28, 21, 17, 13], MAX_LEN,
                                        70 + 10 * i))
    hq, hkv, hd, _, _, scale = DENSE_DECODE["gemma2"]
    cases.update(decode_entry_cases("gemma2_t1024", hq, hkv, hd, 256, 0.0,
                                    scale, dtype, LONG_LENS, T_LONG, 120))
    b, h, hd, n = MAX_BATCH, 12, 64, BERT_SEQ
    q, k, v = (randn((b, n, h, hd), dtype, seed).transpose(1, 2)
               for seed in (130, 131, 132))
    cases["flash_attention[bert_s512]"] = dict(
        call=lambda: kernels.flash_attention(q, k, v, scale=hd ** -0.5,
                                             causal=False),
        plain=lambda: attention_ref(q, k, v, scale=hd ** -0.5,
                                    causal=False),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, scale=hd ** -0.5),
        bytes=4 * b * n * h * hd * es, flops=4 * b * n * n * h * hd)
    for d, f in DENSE_WIDTHS:
        x = randn((MAX_BATCH, 1, d), dtype, 140)
        r = randn((MAX_BATCH, 1, d), dtype, 141)
        w = randn((d,), dtype, 142) + 1.0
        wq = randn((d, f), dtype, 143, scale=0.02)
        rows = MAX_BATCH
        cases[f"rmsnorm_matmul[d{d}]"] = dict(
            call=lambda x=x, w=w, wq=wq: kernels.rmsnorm_matmul(x, w, wq),
            plain=lambda x=x, w=w, wq=wq: rmsnorm_matmul_ref(x, w, wq),
            library=None,
            unfused=lambda x=x, w=w, wq=wq, d=d: torch.matmul(
                F.rms_norm(x, (d,), w, eps=1e-5), wq),
            bytes=(2 * rows * d + d + d * f + rows * f) * es,
            flops=2 * rows * d * f + 4 * rows * d)
        cases[f"residual_rmsnorm[d{d}]"] = dict(
            call=lambda x=x, w=w, r=r: kernels.residual_rmsnorm(x, w, r),
            plain=lambda x=x, w=w, r=r: residual_rmsnorm_ref(x, w, r),
            library=None,
            bytes=(4 * rows * d + d) * es, flops=5 * rows * d)
    return cases


def wkv_inputs(b, t, h, hd, seed) -> tuple:
    """r, k, v, logw (B,T,H,hd), u, s0 in f32 at the scales of the
    reference's WKV6 test (``tests/test_kernels.py::test_wkv6``)."""
    f32 = torch.float32
    return (randn((b, t, h, hd), f32, seed, 0.5),
            randn((b, t, h, hd), f32, seed + 1, 0.5),
            randn((b, t, h, hd), f32, seed + 2),
            -torch.exp(randn((b, t, h, hd), f32, seed + 3, 0.5) - 2.0),
            randn((h, hd), f32, seed + 4, 0.3),
            randn((b, h, hd, hd), f32, seed + 5, 0.1))


def rwkv_cases(cfg, dtype):
    """The RWKV-6 path's kernels at its shapes, keyed as in
    ``main_path_cases``.  The norm at the decode rows (4, 1, D) and a
    prefill's (1, PROMPT, D), with and without a residual.  WKV6 only in
    f32 (the layer calls it so): decode (B 4, T 1), a PROMPT-token
    prefill, T 64 and T 1024 (many chunks in one launch), and the
    reference's extreme-decay case (decays exp(-50) and exp(-1e-4) in
    turn), which must stay finite and is held against the literal float64
    recurrence."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    w = randn((d,), dtype, 30) + 1.0
    cases = {}
    for tag, (b, t) in (("", (MAX_BATCH, 1)), ("prefill", (1, PROMPT))):
        x = randn((b, t, d), dtype, 31)
        res = randn((b, t, d), dtype, 32)
        n = b * t
        for res_tag, r in (("", res), ("no_residual", None)):
            sub = "_".join(p for p in (tag, res_tag) if p)
            cases["rmsnorm" + (f"[{sub}]" if sub else "")] = dict(
                call=lambda x=x, r=r: kernels.rmsnorm(x, w, r),
                plain=lambda x=x, r=r: rmsnorm_ref(x, w, r),
                library=(None if r is not None else
                         lambda x=x: F.rms_norm(x, (d,), w,
                                                eps=cfg.norm_eps)),
                bytes=((4 if r is not None else 2) * n * d + d) * es,
                flops=(5 if r is not None else 4) * n * d)
    if dtype != torch.float32:
        return cases
    for tag, (b, t, hh, dd, seed) in (
            ("", (MAX_BATCH, 1, h, hd, 40)),
            ("prefill", (1, PROMPT, h, hd, 46)),
            ("t64", (1, 64, h, hd, 52)),
            ("t1024", (1, 1024, h, hd, 64)),
            ("extreme_decay", (1, 32, 1, 8, 58))):
        args = wkv_inputs(b, t, hh, dd, seed)
        plain = wkv6_ref
        if tag == "extreme_decay":
            even = (torch.arange(t, device=DEV) % 2 == 0)[None, :, None,
                                                         None]
            args = (*args[:3],
                    torch.where(even, -50.0, -1e-4).expand(
                        b, t, hh, dd).contiguous(),
                    torch.zeros_like(args[4]), torch.zeros_like(args[5]))
            plain = wkv6_oracle
        cases["wkv6" + (f"[{tag}]" if tag else "")] = dict(
            call=lambda a=args: kernels.wkv6(*a),
            plain=lambda a=args, p=plain: p(*a),
            library=None, f32_only=True, finite=True,
            # r, k, v, logw and o per token, u, the state read and written
            bytes=4 * (5 * b * t * hh * dd + hh * dd + 2 * b * hh * dd * dd),
            # per token and head: r S (2 hd^2), the state update (3 hd^2),
            # the bonus (3 hd) and exp (hd)
            flops=b * t * hh * (5 * dd * dd + 4 * dd))
    return cases


def phase_kernels(cfg, rcfg) -> dict:
    """Kernel vs plain version at each main path's shapes (SmolLM-360M
    ``cfg``, RWKV-6 ``rcfg``); returns the bf16 rows (with the f32 error;
    an f32-only kernel's f32 rows), keyed as the cases are."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = {**main_path_cases(cfg, dtype), **flash_cases(cfg, dtype),
                 **decode_long_cases(cfg, dtype), **rwkv_cases(rcfg, dtype),
                 **dense_cases(dtype)}
        for name, c in cases.items():
            out, ref = c["call"](), c["plain"]()
            err = max_err(out, ref)
            bound = rel_bound(ref, dtype)
            if not err <= bound:
                fail(f"{name} {dtype}: max |kernel - plain| {err:.3g} > "
                     f"{bound:.3g}")
            if c.get("finite") and not all(
                    torch.isfinite(o).all().item() for o in out):
                fail(f"{name} {dtype}: the kernel's output is not finite")
            if "contiguous" in c:
                c_err = max_err(out, c["contiguous"]())
                if not c_err <= bound:
                    fail(f"{name} {dtype}: max |paged - contiguous kernel| "
                         f"{c_err:.3g} > {bound:.3g}")
                print(f"phase 2: {name} {str(dtype)[6:]}: max |paged - "
                      f"contiguous kernel| on the same logical KV {c_err:.3g}"
                      f" (<= {bound:.3g})")
                rows.setdefault(name, {})[
                    f"vs_contiguous_max_abs_err_{str(dtype)[6:]}"] = c_err
            k_ms, k_host = time_ms(c["call"])
            p_ms, p_host = time_ms(c["plain"])
            lib_ms = time_ms(c["library"])[0] if c["library"] else None
            b_ms, by = bound_ms(c["bytes"], c["flops"], dtype)
            lib = "null" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
            # the pair of PyTorch calls a fused kernel replaces: not one
            # call, so not the library time
            unf_ms = time_ms(c["unfused"])[0] if "unfused" in c else None
            unf = ("" if unf_ms is None else
                   f"  unfused pair (F.rms_norm + torch.matmul) "
                   f"{unf_ms * 1e3:.2f} us")
            print(f"phase 2: {name:38s} {str(dtype)[6:]:9s} max_err "
                  f"{err:.3g} (<= {bound:.3g})  device: kernel "
                  f"{k_ms * 1e3:.2f} us  plain {p_ms * 1e3:.2f} us  library "
                  f"{lib}{unf}  bound {b_ms * 1e3:.4f} us ({by});  host: "
                  f"kernel {k_host * 1e3:.2f} us  plain {p_host * 1e3:.2f} us")
            row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
                       host_ms=k_host, plain_host_ms=p_host)
            if unf_ms is not None:
                row["unfused_pair_ms"] = unf_ms
            rows.setdefault(name, {})
            if dtype == torch.float32:
                rows[name]["max_abs_err_f32"] = err
            if dtype != torch.float32 or c.get("f32_only"):
                rows[name].update(row)
    return rows


def phase_dispatch_cost(cfg) -> dict:
    """What a wrapper's host time holds since the wrappers became
    ``torch.library`` custom ops: ``decode_attention`` at the decode step's
    shapes (bf16, B 4, lengths 28/21/17/13) through its wrapper, through
    its op overload (the dispatcher, no wrapper checks) and through its
    CUDA implementation called directly (no dispatcher); host µs a call,
    back to back, as phase 2 times them."""
    b, hq, hkv, hd = MAX_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = torch.bfloat16
    q = randn((b, hq, hd), dt, 3)
    k = randn((b, MAX_LEN, hkv, hd), dt, 1).transpose(1, 2)
    v = randn((b, MAX_LEN, hkv, hd), dt, 2).transpose(1, 2)
    lens = torch.tensor([28, 21, 17, 13], dtype=torch.int32, device=DEV)
    scale = hd ** -0.5
    calls = {
        "wrapper": lambda: kernels.decode_attention(q, k, v, lens,
                                                    scale=scale),
        "op_overload": lambda: kernels.decode_attention.op(
            q, k, v, lens, -1, scale, 0, 0.0),
        "cuda_implementation": lambda: _decode_launch(q, k, v, lens, -1,
                                                      scale, 0, 0.0),
    }
    ref = calls["cuda_implementation"]()
    for name, fn in calls.items():
        if not torch.equal(fn(), ref):
            fail(f"dispatch cost: decode_attention by {name} differs from "
                 "its CUDA implementation called directly")
    host = {name: time_ms(fn)[1] * 1e3 for name, fn in calls.items()}
    dispatcher = host["op_overload"] - host["cuda_implementation"]
    print("phase 2: decode_attention host us a call: "
          + ", ".join(f"{n} {t:.2f}" for n, t in host.items())
          + f"; the dispatcher's share {dispatcher:.2f} us, the wrapper's "
          f"own {host['wrapper'] - host['op_overload']:.2f} us")
    return host


# ------------------------------------------------------------------ phase 3
def compare_logits(a, b, tol, what):
    """max |a - b| <= tol, and argmax agrees except where b's top-2 gap is
    below tol.  Returns the max abs difference."""
    torch.cuda.synchronize()
    err = (a - b).abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        fail(f"{what}: max |kernel - plain| logits {err:.3g} > {tol}")
    top2 = b.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flip = (a.argmax(-1) != b.argmax(-1)) & (gap >= tol)
    if flip.any():
        fail(f"{what}: {int(flip.sum())} argmax flips where the top-2 gap "
             f">= {tol}")
    return err


def kernel_vs_plain_logits(cfg, params, prompt, steps, label,
                           lens0=None) -> tuple:
    """f32 logits of ``prompt`` (B x S: a prefill into a fresh cache, then
    one batched decode step per entry of ``steps``, step i at the rows'
    lengths ``lens0 + i``, S by default; with ``steps`` None one forward
    without cache) through the kernels and through their plain versions;
    fails unless each call agrees within LOGIT_TOL_F32 (argmax too,
    outside near ties).  Returns (the largest difference, the kernels'
    logits of each call)."""
    b, n = prompt.shape
    lens0 = np.full(b, n) if lens0 is None else lens0
    out = {}
    for mode in ("kernel", "plain"):
        ctx = plain_kernels() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            if steps is None:
                out[mode] = [forward(params, prompt, cfg)[0]]
                continue
            cache = make_cache(cfg, b, MAX_LEN, device=DEV)
            logits, cache = forward(params, prompt, cfg, cache=cache)
            got = [logits]
            for i, tok in enumerate(steps):
                lg, cache = forward(params, tok, cfg, cache=cache,
                                    lengths=lens0 + i)
                got.append(lg)
            out[mode] = got
            del cache
    errs = [compare_logits(a, b_, LOGIT_TOL_F32, f"{label} call {i}")
            for i, (a, b_) in enumerate(zip(out["kernel"], out["plain"]))]
    got = out["kernel"]
    del out
    torch.cuda.empty_cache()
    return max(errs), got


def phase_logits_f32(cfg) -> None:
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(cfg32, gen, device=DEV)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MAX_BATCH, BUCKET)).astype(np.int64))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (MAX_BATCH, 1)))
             for _ in range(3)]
    lens0 = np.array([16, 9, 12, 5])       # ragged rows, as after prefills
    err, kernel_logits = kernel_vs_plain_logits(cfg32, params, prompt, steps,
                                                "f32 logits", lens0)
    print(f"phase 3: full-width {cfg.name} f32 ({cfg.n_layers} layers), "
          f"prefill (4 x {BUCKET}) + 3 decode steps: max |kernel - plain| "
          f"logits {err:.3g} (<= {LOGIT_TOL_F32}), argmax agrees")

    # the paged path through its kernels against the contiguous one: each
    # row's prompt in chunks of CHUNK, then the same ragged decode steps
    n_pages = MAX_BATCH * (MAX_LEN // BLOCK)
    cache = make_paged_cache(cfg32, n_pages, BLOCK, device=DEV)
    tables = np.full((MAX_BATCH, MAX_LEN // BLOCK), n_pages, np.int32)
    tables[:, :2] = np.random.default_rng(1).permutation(n_pages)[
        :2 * MAX_BATCH].reshape(MAX_BATCH, 2)          # 32 positions a row
    n0 = kernels.launch_counts()
    pre = torch.empty_like(kernel_logits[0])
    for r in range(MAX_BATCH):
        for t0 in range(0, BUCKET, CHUNK):
            lg, cache = forward(params, prompt[r:r + 1, t0:t0 + CHUNK], cfg32,
                                cache=cache, cache_index=t0,
                                block_tables=tables[r:r + 1])
            pre[r, t0:t0 + CHUNK] = lg[0]
    got = [pre]
    for i, tok in enumerate(steps):
        lg, cache = forward(params, tok, cfg32, cache=cache,
                            lengths=lens0 + i, block_tables=tables)
        got.append(lg)
    n1 = kernels.launch_counts()
    L = cfg.n_layers
    if (n1["paged_decode_attention"] - n0["paged_decode_attention"] != 3 * L
            or n1["flash_attention"] - n0["flash_attention"]
            != MAX_BATCH * (BUCKET // CHUNK) * L):
        fail(f"phase 3 paged path launches {n0} -> {n1}")
    errs = [compare_logits(a, b, LOGIT_TOL_F32,
                           f"f32 paged vs contiguous logits call {i}")
            for i, (a, b) in enumerate(zip(got, kernel_logits))]
    print(f"phase 3: paged path (block {BLOCK}, chunks of {CHUNK}, then the "
          f"same 3 decode steps) vs the contiguous path, both with kernels: "
          f"max |paged - contiguous| logits {max(errs):.3g} "
          f"(<= {LOGIT_TOL_F32}), argmax agrees")
    del params, cache
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 4
def want_launches(cfg, attention: str = "", plan: str = "jit") -> tuple:
    """Hand-written kernel launches per decode step (``attention`` is the
    decode attention kernel of the path) and per prefill call under
    ``plan``.  ``jit`` launches the norms where the model calls them;
    ``fused`` too, its rules lowering RWKV-6's legacy-norm windows to
    ``residual_rmsnorm``; the other plans run the norms as their plain
    versions.  RWKV-6: ``wkv6`` L and 2L+1 norms in both."""
    L = cfg.n_layers
    zero = {name: 0 for name in kernels.WRAPPERS}
    norms = plan in ("jit", "fused")
    if is_recurrent(cfg):
        name = "rmsnorm" if plan == "jit" else "residual_rmsnorm"
        per = {**zero, "wkv6": L, **({name: 2 * L + 1} if norms else {})}
        return per, dict(per)
    fused = ({"residual_rmsnorm": L + 1, "rmsnorm_matmul": L} if norms
             else {})
    return ({**zero, **fused, attention: L},
            {**zero, **fused, "flash_attention": L})


def check_first_tokens(eng, done, cfg) -> int:
    """The served first tokens against the plain versions on the same bf16
    weights: they may differ only where the plain top-2 gap is below
    LOGIT_TOL_BF16.  Returns how many agree."""
    width = max(len(r.prompt) for r in done)
    prompts = np.zeros((len(done), width), np.int64)
    order = sorted(done, key=lambda r: r.rid)
    for i, r in enumerate(order):
        prompts[i, :len(r.prompt)] = r.prompt
    first = torch.tensor([r.generated[0] for r in order], device=DEV)
    with plain_kernels():
        logits, _ = forward(eng.params, torch.from_numpy(prompts), cfg)
    last = torch.tensor([len(r.prompt) - 1 for r in order], device=DEV)
    plain = logits[torch.arange(len(order), device=DEV), last]
    top2 = plain.topk(2, dim=-1).values
    flips = (plain.argmax(-1) != first) & (top2[:, 0] - top2[:, 1]
                                           >= LOGIT_TOL_BF16)
    if flips.any():
        fail(f"{int(flips.sum())} served first tokens disagree with the "
             f"plain bf16 forward where its top-2 gap >= {LOGIT_TOL_BF16}")
    return int((plain.argmax(-1) == first).sum())


def serve_argv(cfg, extra, plan: str) -> list:
    return ["--arch", cfg.name, "--requests", str(N_REQ), "--max-batch",
            str(MAX_BATCH), "--max-len", str(MAX_LEN), "--device", "cuda",
            "--plan", plan, *extra]


def phase_serve(cfg, phase: int, extra=()) -> tuple:
    """``repro_torch.launch.serve --plan eager`` at full width in bf16
    (warmup + measured run), with every launch count reset just before and
    read just after.  ``extra`` selects the cache; the launches must match
    the path's table per decode step and per prefill call (a prefill chunk
    when paged).  Returns (counts, report, engine, finished requests)."""
    argv = serve_argv(cfg, extra, "eager")
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        eng, done = serve.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"phase {phase}: serve {' '.join(argv)}")
    print(f"  report {json.dumps(rep)}")
    print(f"  launches (warmup + measured run) {counts}")
    st = eng.stats
    if len(done) != N_REQ or any(r.status != "done" for r in done):
        fail(f"serve finished {len(done)} of {N_REQ} requests")
    for r in done:
        if len(r.generated) != 16 or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"request {r.rid} generated {r.generated}")
    paged = eng.kv is not None
    want_step, want_pre = want_launches(
        cfg, "paged_decode_attention" if paged else "decode_attention",
        "eager")
    if st.kernel_launches_per_decode_step != want_step:
        fail(f"launches per decode step {st.kernel_launches_per_decode_step}"
             f" != {want_step}")
    n_pre = st.prefill_chunks if paged else st.prefills
    if st.prefill_kernel_launches != n_pre * sum(want_pre.values()):
        fail(f"prefill launches {st.prefill_kernel_launches} != "
             f"{n_pre} x {sum(want_pre.values())}")
    runs = 2                               # warmup + measured, same schedule
    want = {name: runs * (st.decode_steps * want_step[name]
                          + n_pre * want_pre[name]) for name in want_step}
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    agree = check_first_tokens(eng, done, cfg)
    print(f"  served first tokens agree with the plain bf16 forward: "
          f"{agree}/{N_REQ}")
    return counts, rep, eng, done


# ------------------------------------------------------------------ phase 5
# device kernel names of the hand-written kernels (csrc/*.cu)
HAND_KERNELS = ("flash_attention", "residual_rmsnorm_kernel",
                "rmsnorm_matmul", "decode_attention", "wkv6")


def device_times(run):
    """Profile ``run``: ({kernel name: (device us, launches)} over the run,
    or None when the profiler saw no device events; the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None, prof
    by = {}
    for e in kern:
        t, n = by.get(e.name, (0.0, 0))
        by[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    return by, prof


def print_hand_kernels(by, calls: int, per: str) -> None:
    """The hand-written kernels' device time inside the profiled run."""
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        if any(h in name for h in HAND_KERNELS):
            print(f"  in {per}: {name[:60]} {n / calls:.0f} calls, "
                  f"{t / calls:.1f} us/{per}, {t / n:.2f} us/call")


def events_busy_ms(step, steps: int) -> float:
    """Device ms per call of ``step`` between CUDA events around it (each
    call waited for), where the profiler sees no device events."""
    total = 0.0
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / steps


def phase_trace(eng, label: str, prefill: bool = False) -> dict:
    """Decode-step wall time, device time by kernel from torch.profiler
    (kernels run in order on one stream, so their sum is the busy time) and
    the host ops with the most self time, for the engine's cache (a paged
    engine steps rows that own two pages each).  With ``prefill``, also the
    device time of a slot's prefill (the serve CLI's 12-token prompt, padded
    to its bucket for attention), with the hand-written kernels' share.
    Returns the step's wall, host (the backend call) and device-busy ms,
    its device kernels and how busy was measured.  Under ``plan="jit"``
    each call replays the engine's captured graph for its signature."""
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, eng.cfg.vocab_size,
                                         (MAX_BATCH, 1)))
    lens = np.array([20, 20, 20, 20])
    steps = 10
    if eng.kv is None:
        def step():
            return eng.backend.decode(eng.cache, toks, lens)
    else:
        bt = np.full((MAX_BATCH, eng.kv.nb_per_slot), eng.kv.sentinel,
                     np.int32)
        bt[:, :2] = np.arange(2 * MAX_BATCH).reshape(MAX_BATCH, 2)

        def step():
            return eng.backend.paged_decode(eng.cache, toks, lens, bt)

    host = []

    def run():
        for _ in range(steps):
            logits, _ = step()
            host.append(eng.backend.last.host_time_s)
            logits.cpu()                   # the engine's host argmax sync

    run()
    torch.cuda.synchronize()
    host.clear()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    out = dict(wall_ms=wall_ms, host_ms=float(np.mean(host)) * 1e3)
    by, prof = device_times(run)
    if by is None:
        out.update(busy_ms=events_busy_ms(lambda: step()[0].cpu(), steps),
                   kernels=None, busy_by="CUDA events")
        print(f"{label}: decode step wall {wall_ms:.3f} ms; the profiler "
              "reported no device events; CUDA events around each call: "
              f"{out['busy_ms']:.3f} ms")
        return out
    busy_ms = sum(t for t, _ in by.values()) / steps / 1e3
    n_kern = sum(n for _, n in by.values()) / steps
    out.update(busy_ms=busy_ms, kernels=n_kern, busy_by="profiler")
    print(f"{label}: decode step (batch {MAX_BATCH}, kv len 20): wall "
          f"{wall_ms:.3f} ms/step unprofiled, host {out['host_ms']:.3f} "
          f"ms/step (the backend call); profiled: device busy "
          f"{busy_ms:.3f} ms/step ({busy_ms / wall_ms:.1%} of the unprofiled "
          f"wall), {n_kern:.0f} device kernels/step")
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / steps:9.1f} us/step {n / steps:6.1f}x  {name[:90]}")
    print_hand_kernels(by, steps, "step")
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    print("  host ops by profiled self time: " + ", ".join(
        f"{a.key} {a.self_cpu_time_total / steps:.0f} us/step "
        f"({a.count / steps:.0f}x)" for a in ops[:8]))
    if not prefill:
        return out
    width = PROMPT if is_recurrent(eng.cfg) else BUCKET
    prompt = torch.from_numpy(rng.integers(0, eng.cfg.vocab_size,
                                           (1, width)))

    def prefills():
        for _ in range(steps):
            logits, _ = eng.backend.prefill(eng.cache, prompt, 0, PROMPT)
            logits.cpu()

    prefills()
    by, _ = device_times(prefills)
    if by is None:
        print(f"{label} prefill: the profiler reported no device events")
        return out
    busy_ms = sum(t for t, _ in by.values()) / steps / 1e3
    out["prefill_busy_ms"] = busy_ms
    print(f"{label} prefill (1 x {width}, slot 0): device busy "
          f"{busy_ms:.3f} ms/prefill, "
          f"{sum(n for _, n in by.values()) / steps:.0f} device kernels")
    print_hand_kernels(by, steps, "prefill")
    return out


# ------------------------------------------------------------------ phase 7
PRESSURE_BLOCKS = 8        # int8 pool of 8 x 16 tokens for 4 slots of 128


def pressure_requests(vocab: int) -> list:
    """Eight requests, four of which share a 32-token prompt prefix: the
    first decodes long, so its pages are live when the other three arrive;
    the rest have 20-token prompts of their own."""
    rng = np.random.default_rng(3)
    prefix = [int(t) for t in rng.integers(0, vocab, 32)]
    shapes = [(True, 48), (False, 8), (False, 8), (False, 8),
              (True, 16), (True, 16), (True, 16), (False, 16)]
    reqs = []
    for rid, (shared, budget) in enumerate(shapes):
        own = [int(t) for t in rng.integers(0, vocab, 8 if shared else 20)]
        reqs.append(Request(rid, prompt=(prefix if shared else []) + own,
                            max_new_tokens=budget))
    return reqs


def plain_int8_logits(params, cfg, toks) -> torch.Tensor:
    """Next-token logits after ``toks`` through the plain versions over an
    int8 paged pool of one row, prefilled in chunks of CHUNK as the engine
    does."""
    n_pages = -(-len(toks) // BLOCK)
    cache = make_paged_cache(cfg, n_pages, BLOCK, kv_dtype="int8",
                             device=DEV)
    table = np.full((1, MAX_LEN // BLOCK), n_pages, np.int32)
    table[0, :n_pages] = np.arange(n_pages)
    with plain_kernels():
        for t0 in range(0, len(toks), CHUNK):
            chunk = torch.tensor([toks[t0:t0 + CHUNK]])
            logits, cache = forward(params, chunk, cfg, cache=cache,
                                    cache_index=t0, block_tables=table)
    return logits[0, -1]


def plain_logits(params, cfg, toks) -> torch.Tensor:
    """Next-token logits after ``toks`` through the plain versions, the
    whole sequence in one forward (bf16, no cache)."""
    with plain_kernels():
        logits, _ = forward(params, torch.tensor([toks]), cfg)
    return logits[0, -1]


def check_near_ties(done, ref_done, params, cfg, names,
                    plain=plain_int8_logits) -> int:
    """One run's tokens against another's of the same requests (the
    pressured int8 run against an unpressured one; jit against eager).  A
    request may diverge only where the plain versions (``plain``: over
    int8 pages by default) put the two tokens within LOGIT_TOL_BF16 of
    each other; its later tokens are then not compared.  ``names`` label
    the two runs.  Returns how many requests agree entirely."""
    ref = {r.rid: r for r in ref_done}
    same = 0
    for r in done:
        want = ref[r.rid].generated
        i = next((i for i, (a, b) in enumerate(zip(r.generated, want))
                  if a != b), None)
        if i is None:
            same += 1
            continue
        logits = plain(params, cfg, r.prompt + want[:i])
        gap = (logits[want[i]] - logits[r.generated[i]]).abs().item()
        if not gap < LOGIT_TOL_BF16:
            fail(f"{names}: request {r.rid} token {i} is "
                 f"{r.generated[i]} {names[0]} and {want[i]} {names[1]}; "
                 f"their plain int8 logits differ by {gap:.3g} >= "
                 f"{LOGIT_TOL_BF16}")
        print(f"  near tie: request {r.rid} token {i} is {r.generated[i]} "
              f"{names[0]} and {want[i]} {names[1]}; their plain "
              f"logits differ by {gap:.3g} < {LOGIT_TOL_BF16}")
    return same


PRESSURE_OPTS = dict(max_batch=MAX_BATCH, max_len=MAX_LEN, device=DEV,
                     cache="paged", kv_dtype="int8", block_size=BLOCK,
                     prefill_chunk=CHUNK, share_prefix=True)


def serve_pressured(cfg, params, plan: str, phase: int) -> tuple:
    """The pool-pressure engine under ``plan``: a warmup run, then the
    measured run with the launch counts reset just before; it must
    preempt, offload, restore and share.  Returns (engine, finished
    requests, counts, report)."""
    eng = ServeEngine(cfg, params, offload="host", plan=plan,
                      num_blocks=PRESSURE_BLOCKS, **PRESSURE_OPTS)
    eng.run(pressure_requests(cfg.vocab_size))
    eng.reset()
    reqs = pressure_requests(cfg.vocab_size)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = eng.stats
    rep = serve.report(eng, done, wall)
    print(f"phase {phase}: pool pressure, int8 pages, {PRESSURE_BLOCKS} "
          f"blocks of {BLOCK}, chunks of {CHUNK}, prefix sharing, host "
          f"offload, plan {plan}")
    print(f"  report {json.dumps(rep)}")
    print(f"  launches (measured run) {counts}")
    if len(done) != len(reqs) or any(
            r.status != "done" or len(r.generated) != r.max_new_tokens
            for r in done):
        fail(f"pool pressure finished {len(done)} of {len(reqs)} requests")
    if not (st.preemptions > 0 and st.prefix_adoptions > 0
            and st.offload_bytes == st.restore_bytes > 0):
        fail(f"pool pressure: preemptions {st.preemptions}, adoptions "
             f"{st.prefix_adoptions}, offload {st.offload_bytes} B, restore "
             f"{st.restore_bytes} B")
    return eng, done, counts, rep


def phase_pool_pressure(cfg, params) -> tuple:
    """``ServeEngine(plan="eager")`` at full width with an int8 paged pool
    too small for the load, chunked prefill, prefix sharing and host
    offload (``serve_pressured``).  Its tokens are then held against the
    same requests served from the default int8 pool, where nothing is
    preempted or offloaded."""
    eng, done, counts, rep = serve_pressured(cfg, params, "eager", 7)
    st, tier = eng.stats, eng.offload_tier
    want_step, want_pre = want_launches(cfg, "paged_decode_attention_quant",
                                        "eager")
    if st.kernel_launches_per_decode_step != want_step:
        fail(f"launches per decode step {st.kernel_launches_per_decode_step}"
             f" != {want_step}")
    if st.prefill_kernel_launches != st.prefill_chunks * sum(
            want_pre.values()):
        fail(f"prefill launches {st.prefill_kernel_launches} != "
             f"{st.prefill_chunks} x {sum(want_pre.values())}")
    want = {name: st.decode_steps * want_step[name]
            + st.prefill_chunks * want_pre[name] for name in want_step}
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    roomy = ServeEngine(cfg, params, plan="eager", **PRESSURE_OPTS)
    free_done = roomy.run(pressure_requests(cfg.vocab_size))
    if roomy.stats.preemptions or len(free_done) != len(done):
        fail(f"the unpressured int8 run preempted {roomy.stats.preemptions} "
             f"times and finished {len(free_done)} of {len(done)} requests")
    same = check_near_ties(done, free_done, params, cfg,
                           ("under pressure", "without"))
    print(f"  tokens agree with the same requests in the default "
          f"{roomy.kv.num_blocks}-block int8 pool (no preemption, no "
          f"offload): {same}/{len(done)} requests token for token")
    del roomy
    copy_s = tier.measured_copy_s
    if not copy_s > 0:
        fail(f"{tier.timed_copies} offload copies timed at {copy_s} s")
    print(f"  {rep['tok_per_s']:.2f} tok/s, mean TTFT "
          f"{rep['mean_ttft_ms']:.2f} ms, mean ITL {rep['mean_itl_ms']:.2f} "
          f"ms, launch tax {rep['measured_launch_tax_per_step_us']:.1f} "
          f"us/step; {st.preemptions} preemptions, {st.prefix_adoptions} "
          f"prefix adoptions ({st.shared_prefix_tokens} tokens), "
          f"{eng.kv.pool.cow_copies_total} copy-on-write copies")
    print(f"  offload: {st.offload_bytes} B out, {st.restore_bytes} B back "
          f"in {st.offload_transfers} block transfers; measured copy time "
          f"{copy_s * 1e6:.1f} us over {tier.timed_copies} copies (one "
          f"pinned buffer per eviction or restore, CUDA events), "
          f"{(st.offload_bytes + st.restore_bytes) / copy_s / 1e9:.2f} GB/s,"
          f" vs modeled tax {st.modeled_offload_tax_s * 1e6:.1f} us "
          f"({eng.platform} link)")
    return counts, rep, eng, done


# ------------------------------------------------------------------ phase 8
RWKV_LOGIT_LAYERS = 4      # depth of the free-running f32 logits check


@contextlib.contextmanager
def checked_rwkv_kernels():
    """Run every ``wkv6`` and ``rmsnorm`` call through its kernel and its
    plain version on the same inputs (the plain one first, before the
    kernel writes the state in place); fail unless they agree within TOL;
    return the kernel's result.  Yields {name: [calls, max error]}."""
    saved = {name: getattr(kernels, name) for name in ("wkv6", "rmsnorm")}
    seen = {name: [0, 0.0] for name in saved}

    def note(name, out, ref):
        err, bound = max_err(out, ref), rel_bound(ref, torch.float32)
        if not err <= bound:
            fail(f"phase 8: {name} call {seen[name][0]} on the model's "
                 f"activations: max |kernel - plain| {err:.3g} > "
                 f"{bound:.3g}")
        seen[name] = [seen[name][0] + 1, max(seen[name][1], err)]

    def rmsnorm(x, weight, residual=None, *, eps):
        out = saved["rmsnorm"](x, weight, residual, eps=eps)
        note("rmsnorm", out, rmsnorm_ref(x, weight, residual, eps))
        return out

    def wkv6(r, k, v, logw, u, s0, *, s_out=None):
        ref = wkv6_ref(r, k, v, logw, u, s0)
        out = saved["wkv6"](r, k, v, logw, u, s0, s_out=s_out)
        note("wkv6", out, ref)
        return out

    kernels.rmsnorm, kernels.wkv6 = rmsnorm, wkv6
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def rwkv_run(params, cfg, prompt, steps, ctx) -> list:
    """Logits of a prefill of ``prompt`` and one decode step per entry of
    ``steps``, from a fresh cache, under ``ctx``."""
    with ctx:
        cache = make_cache(cfg, prompt.shape[0], MAX_LEN, device=DEV)
        logits, cache = forward(params, prompt, cfg, cache=cache)
        got = [logits]
        for i, tok in enumerate(steps):
            lg, cache = forward(params, tok, cfg, cache=cache,
                                lengths=np.full(tok.shape[0],
                                                prompt.shape[1] + i))
            got.append(lg)
    return got


def phase_logits_rwkv(cfg) -> None:
    """Full-width RWKV-6 3B in f32: a PROMPT-token prefill of MAX_BATCH
    rows and 3 batched decode steps.  (a) At full depth, every kernel call
    is held against its plain version on the model's own activations.  (b)
    Free-running logits, kernels against plain versions, within
    LOGIT_TOL_F32 at RWKV_LOGIT_LAYERS layers.  With these random weights
    the f32 function is ill-conditioned in depth: a rounding difference of
    one ulp grows layer by layer, so (c) prints, unchecked, the 32-layer
    logits of kernels against plain and of the plain versions at batch
    MAX_BATCH against the same rows one at a time (other GEMM kernels)."""
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(1),
                         device=DEV)
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, PROMPT)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, 1)))
             for _ in range(3)]
    n0 = kernels.launch_counts()
    with checked_rwkv_kernels() as seen:
        full = rwkv_run(params, cfg32, prompt, steps,
                        contextlib.nullcontext())
    n1 = kernels.launch_counts()
    want_step, _ = want_launches(cfg32)
    if {k: n1[k] - n0[k] for k in n1} != {k: 4 * v
                                          for k, v in want_step.items()}:
        fail(f"phase 8 launches {n0} -> {n1}")
    print(f"phase 8: full-width {cfg.name} f32, {cfg.n_layers} layers, "
          f"prefill ({MAX_BATCH} x {PROMPT}) + 3 decode steps: every "
          f"kernel call against its plain version on the same activations:"
          f" " + ", ".join(f"{n} {c} calls, max err {e:.3g}"
                           for n, (c, e) in seen.items())
          + f" (<= {TOL['torch.float32']} x max(1, |plain|))")
    small = cfg32.replace(n_layers=RWKV_LOGIT_LAYERS)
    sub = {**params, "blocks": params["blocks"][:RWKV_LOGIT_LAYERS]}
    got = rwkv_run(sub, small, prompt, steps, contextlib.nullcontext())
    ref = rwkv_run(sub, small, prompt, steps, plain_kernels())
    errs = [compare_logits(a, b, LOGIT_TOL_F32, f"rwkv f32 logits call {i}")
            for i, (a, b) in enumerate(zip(got, ref))]
    print(f"  {RWKV_LOGIT_LAYERS} layers, free running: max |kernel - "
          f"plain| logits {max(errs):.3g} (<= {LOGIT_TOL_F32}), argmax "
          f"agrees")
    plain_full = rwkv_run(params, cfg32, prompt, steps, plain_kernels())
    with plain_kernels():
        rows = torch.cat([forward(params, prompt[i:i + 1], cfg32)[0]
                          for i in range(MAX_BATCH)])
    torch.cuda.synchronize()
    drift = max((a - b).abs().max().item() for a, b in zip(full, plain_full))
    print(f"  {cfg.n_layers} layers, free running (not checked): max "
          f"|kernel - plain| logits {drift:.3g}; plain at batch {MAX_BATCH}"
          f" vs the same rows one at a time, prefill "
          f"{(plain_full[0] - rows).abs().max().item():.3g}")
    del params, full, plain_full, got, ref, rows
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9
def first_difference(params, cfg, prompt, served: list) -> tuple:
    """Run the unpadded incremental forward (the prompt in one call, then
    one token per call, batch 1) greedily beside the ``served`` tokens.
    Returns (index of the first token that differs, or None; the
    incremental logits' gap between the two tokens there)."""
    cache = make_cache(cfg, 1, MAX_LEN, device=DEV)
    logits, cache = forward(params, torch.tensor([prompt]), cfg, cache=cache)
    for i, tok in enumerate(served):
        row = logits[0, -1]
        mine = int(row.argmax())
        if mine != tok:
            return i, (row[mine] - row[tok]).abs().item()
        logits, cache = forward(params, torch.tensor([[tok]]), cfg,
                                cache=cache,
                                lengths=np.array([len(prompt) + i]))
    return None, 0.0


def check_rwkv_streams(cfg) -> None:
    """An f32 engine at full width and 2 layers serves the CLI's requests
    (PROMPT-token prompts, 16 new tokens, max_batch 4); every request's
    whole token stream must equal the unpadded incremental forward's.  A
    prompt padded to its bucket (16) would run 4 pad tokens through the
    recurrence and diverge.  Batched decode and batch-1 decode may round
    differently, so a stream may part only where the incremental logits of
    the two tokens lie within LOGIT_TOL_F32; it is not compared further."""
    cfg2 = cfg.replace(n_layers=2, param_dtype="float32",
                       compute_dtype="float32")
    params = init_params(cfg2, torch.Generator(device=DEV).manual_seed(2),
                         device=DEV)
    eng = ServeEngine(cfg2, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      plan="eager", device=DEV)
    done = eng.run(serve.make_requests(N_REQ, cfg.vocab_size, 16))
    if len(done) != N_REQ or any(len(r.generated) != 16 for r in done):
        fail(f"phase 9 f32 streams: {len(done)} requests finished")
    same = 0
    for r in done:
        i, gap = first_difference(params, cfg2, r.prompt, r.generated)
        if i is None:
            same += 1
        elif not gap < LOGIT_TOL_F32:
            fail(f"phase 9 f32 streams: request {r.rid} token {i} is "
                 f"{r.generated[i]} served and differs from the unpadded "
                 f"incremental forward by {gap:.3g} >= {LOGIT_TOL_F32}")
    print(f"phase 9: f32 {cfg.name} at 2 layers, {N_REQ} requests of "
          f"{PROMPT}-token prompts, 16 new tokens: {same}/{N_REQ} whole "
          f"streams equal the unpadded incremental forward")
    del eng, params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 11
PAGED = ["--cache", "paged", "--block-size", str(BLOCK)]
# cell -> (config: "smollm" or "rwkv", serve flags, trace a prefill too)
JIT_CELLS = {"contiguous": ("smollm", [], True),
             "paged_bf16": ("smollm", PAGED, False),
             "paged_int8_pressure": ("smollm", None, False),
             "rwkv": ("rwkv", [], True)}


def cell_row(rep, trace) -> dict:
    """One plan's numbers in a cell: the measured serve run's (decode step
    wall and host ms, tok/s, TTFT, ITL, graphs) and the trace's."""
    return dict(
        step_ms=rep["mean_decode_step_ms"],
        host_ms=rep["measured_launch_tax_per_decode_step_us"] / 1e3,
        trace_wall_ms=trace["wall_ms"], trace_host_ms=trace["host_ms"],
        busy_ms=trace["busy_ms"], busy_by=trace["busy_by"],
        idle=1.0 - trace["busy_ms"] / trace["wall_ms"],
        kernels=trace["kernels"],
        prefill_busy_ms=trace.get("prefill_busy_ms"),
        tok_per_s=rep["tok_per_s"], mean_ttft_ms=rep["mean_ttft_ms"],
        p50_itl_ms=rep["p50_itl_ms"], p99_itl_ms=rep["p99_itl_ms"],
        dispatches=rep["dispatches_per_decode_step"],
        graphs=rep["graphs_captured"], capture_s=rep["graph_capture_s"],
        graph_mb=rep["graph_memory_bytes"] / 2 ** 20)


def attention_of(eng) -> str:
    if eng.kv is None:
        return "decode_attention"
    return ("paged_decode_attention_quant" if eng.kv_dtype == "int8"
            else "paged_decode_attention")


def check_launches(cell, plan, eng, rep) -> None:
    """The path's hand-written launches per decode step and per prefill
    call (a prefill chunk when paged) under ``plan``."""
    want_step, want_pre = want_launches(eng.cfg, attention_of(eng), plan)
    got = {k: v for k, v in rep["kernel_launches_per_decode_step"].items()
           if v}
    if got != {k: v for k, v in want_step.items() if v}:
        fail(f"{cell} {plan}: launches per decode step {got} != "
             f"{want_step}")
    n_pre = rep["prefill_chunks"] if eng.kv is not None else rep["prefills"]
    if rep["prefill_kernel_launches"] != n_pre * sum(want_pre.values()):
        fail(f"{cell} {plan}: prefill launches "
             f"{rep['prefill_kernel_launches']} != {n_pre} x "
             f"{sum(want_pre.values())}")


def check_jit(cell, rep, erep, done, edone, params, cfg) -> None:
    """The jit run against the eager run of the same cell: the same
    requests finished, one dispatch per decode step, the jit path's
    launches; tokens equal eager's except at a near tie (eager runs the
    norms as their plain bf16 versions: other arithmetic)."""
    if len(done) != len(edone) or any(r.status != "done" for r in done):
        fail(f"{cell} jit: finished {len(done)} of {len(edone)} requests")
    if rep["dispatches_per_decode_step"] != 1.0:
        fail(f"{cell} jit: {rep['dispatches_per_decode_step']} dispatches "
             "per decode step, not 1")
    if rep["decode_steps"] != erep["decode_steps"]:
        fail(f"{cell} jit: {rep['decode_steps']} decode steps, eager "
             f"{erep['decode_steps']}")
    plain = (plain_int8_logits if cell == "paged_int8_pressure"
             else plain_logits)
    same = check_near_ties(done, edone, params, cfg,
                           ("under jit", "under eager"), plain)
    print(f"  {cell}: jit tokens equal eager's in {same}/{len(done)} "
          f"requests (the rest part at a printed near tie); 1 dispatch per "
          f"decode step (eager {erep['dispatches_per_decode_step']:.0f}); "
          "launches per decode step and per prefill as the jit path's")


def serve_cell(cell, c, params, plan: str, phase: int) -> tuple:
    """Serve ``cell`` under ``plan`` (warmup + measured run) with the
    launch counts reset just before and read just after.  Returns
    (engine, finished requests, report, counts)."""
    extra = JIT_CELLS[cell][1]
    if extra is None:
        eng, done, counts, rep = serve_pressured(c, params, plan, phase)
        return eng, done, rep, counts
    return serve_flags(c, extra, plan, phase)


def serve_flags(c, extra, plan: str, phase: int) -> tuple:
    """``repro_torch.launch.serve`` of ``c`` with the cache flags ``extra``
    under ``plan``, counted as ``serve_cell`` does."""
    argv = serve_argv(c, extra, plan)
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        eng, done = serve.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"phase {phase}: serve {' '.join(argv)}")
    print(f"  report {json.dumps(rep)}")
    return eng, done, rep, counts


def print_row(phase: int, cell: str, plan: str, r: dict) -> None:
    pre = ("" if r["prefill_busy_ms"] is None else
           f", prefill busy {r['prefill_busy_ms']:.3f} ms")
    print(f"phase {phase}: {cell} {plan}: decode step {r['step_ms']:.3f}"
          f" ms wall, {r['host_ms']:.3f} ms host (serve); trace: "
          f"{r['trace_wall_ms']:.3f} ms wall, {r['trace_host_ms']:.3f}"
          f" ms host, {r['busy_ms']:.3f} ms device busy "
          f"({r['busy_by']}), idle {r['idle']:.1%}{pre}; "
          f"{r['tok_per_s']:.1f} tok/s, mean TTFT "
          f"{r['mean_ttft_ms']:.2f} ms, ITL p50 {r['p50_itl_ms']:.3f}"
          f" / p99 {r['p99_itl_ms']:.3f} ms; {r['dispatches']:.0f} "
          f"dispatches/step; {r['graphs']} graphs, "
          f"{r['capture_s']:.3f} s capture, {r['graph_mb']:.1f} MiB")


def phase_jit(cfg, rcfg, eager: dict) -> tuple:
    """Phase 11: each cell served again under ``--plan jit`` (the int8
    pool-pressure engine under ``plan="jit"``, with the paged run's
    weights), checked against its eager run (``eager[cell]``: report,
    finished requests, trace) and traced as in phases 5-10.  Returns
    ({cell: {plan: numbers}}, {cell: finished jit requests}, {cell: launch
    counts of the jit run})."""
    rows, jit_done, counts, params = {}, {}, {}, None
    for cell, (arch, extra, prefill) in JIT_CELLS.items():
        c = cfg if arch == "smollm" else rcfg
        erep, edone, etrace = eager[cell]
        eng, done, rep, counts[cell] = serve_cell(cell, c, params, "jit", 11)
        check_jit(cell, rep, erep, done, edone, eng.params, c)
        check_launches(cell, "jit", eng, rep)
        trace = phase_trace(eng, f"phase 11 {cell} jit trace", prefill)
        rows[cell] = {"eager": cell_row(erep, etrace),
                      "jit": cell_row(rep, trace)}
        jit_done[cell] = done
        for plan, r in rows[cell].items():
            print_row(11, cell, plan, r)
        params = eng.params if cell == "paged_bf16" else None
        del eng
        torch.cuda.empty_cache()
    print("phase 11: " + json.dumps(rows))
    return rows, jit_done, counts


# ------------------------------------------------------------------ phase 12
# cell -> the launch plans phase 12 serves it under
PLAN_CELLS = {"contiguous": ("whole_graph", "chain", "auto", "fused"),
              "paged_bf16": ("auto", "fused"),
              "paged_int8_pressure": ("auto", "fused"),
              "rwkv": ("auto", "fused")}
EQ1_BATCHES = (1, 2, 4)
# profiles per point of the Eq. 1 timeline (the median is kept), and
# profiles tried: the profiler's host and device clocks sometimes disagree
# by microseconds to milliseconds (kernels then seem to start before their
# launch call), and such a profile is discarded.  How often varies from
# process to process on an H100, from a few profiles to nearly all; a
# point with no profile left is printed as not measured
EQ1_PROFILES, EQ1_ATTEMPTS = 3, 12


def planned(eng, decode: bool) -> list:
    """The engine's planned bodies: its decode step(s) or its prefills."""
    kinds = ("decode", "paged_decode") if decode else ("prefill",
                                                       "paged_prefill")
    return [pf for key, pf in eng.backend._planned_fns.items()
            if key[0] in kinds]


def rule_hits_per_call(pfs) -> list:
    """Each planned body's fused rule hits, one call's worth."""
    return [{n: pf.rule_names.count(n) for n in sorted(set(pf.rule_names))}
            for pf in pfs]


def plan_row(rep, trace, eng) -> dict:
    dec, pre = planned(eng, True), planned(eng, False)
    pf = eng.backend.planned_decode
    n_pre = rep["prefill_chunks"] if eng.kv is not None else rep["prefills"]
    return dict(
        cell_row(rep, trace),
        prefill_dispatches=sorted({p.n_launches for p in pre}),
        launches_per_step={k: v for k, v in
                           rep["kernel_launches_per_decode_step"].items()
                           if v},
        launches_per_prefill=rep["prefill_kernel_launches"] / max(n_pre, 1),
        rule_hits_per_call=rule_hits_per_call(dec + pre),
        modeled_tklqt_us=pf.modeled_tklqt_s * 1e6,
        trace_nodes=len(pf.trace.kernels), trace_s=pf.trace.seconds,
        plan_s=rep["trace_s"])


def auto_candidates(eng) -> list:
    """The plans ``auto`` chose from for the decode step (the cost-aware
    partition and each chain length), with their modeled TKLQT and IL on
    the ``Intel+H100`` row; printed, the chosen one first."""
    choice = Planner(eng.backend.planned_decode.trace, "Intel+H100").auto()
    out = [dict(strategy=e.plan.strategy, length=e.plan.length,
                dispatches=e.plan.n_launches, tklqt_us=e.tklqt * 1e6,
                il_us=e.il * 1e6) for e in choice.evaluated]
    print("  auto's candidates for the decode step (modeled, Intel+H100): "
          + "; ".join(f"{c['strategy']}"
                      + (f" L={c['length']}" if c["length"] else "")
                      + f" {c['dispatches']} dispatches, TKLQT "
                      f"{c['tklqt_us']:.1f} us, IL {c['il_us']:.1f} us"
                      for c in out))
    return out


def check_fused(cell, eng, done, jit_done) -> None:
    """fused serves jit's tokens (the same kernels on the same inputs) and
    finds the model's norm windows in every call."""
    want = {r.rid: r.generated for r in jit_done}
    bad = [r.rid for r in done if r.generated != want[r.rid]]
    if bad or len(done) != len(jit_done):
        fail(f"{cell} fused: requests {bad} served other tokens than "
             f"under jit ({len(done)} of {len(jit_done)} finished)")
    L = eng.cfg.n_layers
    for hits in rule_hits_per_call(planned(eng, True) + planned(eng, False)):
        ok = (sum(hits.values()) == 2 * L + 1 if is_recurrent(eng.cfg) else
              hits == {"residual_rmsnorm": L, "rmsnorm": 1,
                       "rmsnorm_matmul": L})
        if not ok:
            fail(f"{cell} fused: rule hits per call {hits}")


def measured_events(run) -> list:
    """The Eq. 1 timeline of ``run`` from torch.profiler: each device
    kernel joined by its correlation id to the runtime call that launched
    it (a kernel of a CUDA graph replay carries the ``cudaGraphLaunch``'s)
    as ``KernelEvent``s, in seconds from the first launch; an event's
    ``operator`` names its launch call.  Returns (events, how many kernels
    start before the call joined to them began); no events where the
    profiler recorded no device kernel (it loses the device activity of
    some profiles, as it misplaces the device clock of others)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    calls, kern = {}, []
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") != "X" or corr is None:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            calls.setdefault(corr, []).append(e)
        elif e.get("cat") == "kernel":
            kern.append(e)
    if not kern:
        return [], 0
    out = []
    for k in kern:
        # the call that launched it: of the calls carrying its correlation
        # id (should an id recur in one trace), the nearest in time
        c = min(calls.get(k["args"]["correlation"], ()),
                key=lambda c: abs(k["ts"] - c["ts"]), default=None)
        if c is None:
            fail(f"Eq. 1 timeline: kernel {k['name'][:60]} has no launch "
                 "call in the trace")
        out.append(KernelEvent(k["name"], c["ts"] * 1e-6,
                               (c["ts"] + c["dur"]) * 1e-6, k["ts"] * 1e-6,
                               (k["ts"] + k["dur"]) * 1e-6,
                               operator=c["name"]))
    out.sort(key=lambda e: (e.kernel_start, e.launch_begin))
    t0 = min(e.launch_begin for e in out)
    for e in out:
        e.launch_begin -= t0
        e.launch_end -= t0
        e.kernel_start -= t0
        e.kernel_end -= t0
    return out, sum(e.kernel_start < e.launch_begin for e in out)


def phase_eq1(cfg, params) -> dict:
    """One SmolLM contiguous decode step (kv len 20) at batch 1, 2 and 4
    under eager and fused: the measured Eq. 1 timeline's TKLQT, AKD, IL
    and GPU idle (of the median kept profile by TKLQT) beside
    the modeled TKLQT of the same trace, then the boundedness inflection
    of the measured eager curve."""
    rows = {}
    for plan in ("eager", "fused"):
        for b in EQ1_BATCHES:
            eng = ServeEngine(cfg, params, max_batch=b, max_len=MAX_LEN,
                              plan=plan, device=DEV)
            rng = np.random.default_rng(2)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
            lens = np.full(b, 20)

            def step():
                eng.backend.decode(eng.cache, toks, lens)[0].cpu()

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            reps, tried = [], 0
            while len(reps) < EQ1_PROFILES and tried < EQ1_ATTEMPTS:
                tried += 1
                ev, early = measured_events(step)
                if not ev:
                    print(f"phase 12: Eq. 1 timeline, {plan} batch {b}: "
                          "the profiler recorded no device kernel in this "
                          "profile; discarded")
                    continue
                if early:
                    print(f"phase 12: Eq. 1 timeline, {plan} batch {b}: "
                          f"{early} of {len(ev)} kernels start before "
                          "their launch call in this profile (its device "
                          "clock is off); discarded")
                    continue
                reps.append((skip_report(ev, "H100 (measured)", 0.0), ev))
            pf = eng.backend.planned_decode
            if not reps:
                # the profiler, not the step: nothing to measure
                rows.setdefault(plan, {})[b] = dict(
                    tklqt_us=None, discarded=tried,
                    dispatches=pf.n_launches,
                    modeled_tklqt_us=pf.modeled_tklqt_s * 1e6)
                print(f"phase 12: Eq. 1 timeline, {plan} decode step, batch "
                      f"{b}: not measured, every one of {tried} profiles has "
                      "a kernel before its launch call or none; modeled "
                      f"TKLQT {pf.modeled_tklqt_s * 1e6:.1f} us (Intel+H100 "
                      "row)")
                del eng
                continue
            reps.sort(key=lambda re: re[0].tklqt)
            rep, ev = reps[len(reps) // 2]       # the median profile
            by_call = {}
            for e in ev:
                by_call[e.operator] = by_call.get(e.operator, 0) + 1
            r = dict(kernels=rep.n_kernels, tklqt_us=rep.tklqt * 1e6,
                     akd_us=rep.akd * 1e6, il_us=rep.il * 1e6,
                     gpu_idle_us=rep.gpu_idle * 1e6,
                     queue_share=rep.queue_share,
                     dispatches=pf.n_launches, launched_by=by_call,
                     profiles_tklqt_us=[x.tklqt * 1e6 for x, _ in reps],
                     discarded=tried - len(reps),
                     modeled_tklqt_us=pf.modeled_tklqt_s * 1e6)
            rows.setdefault(plan, {})[b] = r
            print(f"phase 12: Eq. 1 timeline, {plan} decode step, batch {b}"
                  f": {r['kernels']} kernels from {r['dispatches']} "
                  f"dispatches (kernels by launch call {by_call}); "
                  f"measured TKLQT over filtered profiles, the median of "
                  f"the {len(reps)} kept "
                  f"{[round(t, 1) for t in r['profiles_tklqt_us']]} "
                  f"({r['discarded']} of {tried} discarded with a kernel "
                  f"before its launch call or none): "
                  f"{r['tklqt_us']:.1f} us (queue share "
                  f"{r['queue_share']:.1%}), AKD "
                  f"{r['akd_us']:.2f} us, IL {r['il_us']:.1f} us, GPU idle "
                  f"{r['gpu_idle_us']:.1f} us; modeled TKLQT "
                  f"{r['modeled_tklqt_us']:.1f} us (Intel+H100 row)")
            del eng
    curve = [rows["eager"][b]["tklqt_us"] for b in EQ1_BATCHES]
    if None in curve:
        print("phase 12: find_inflection not run: an eager point of the Eq. "
              "1 timeline was not measured")
        rows["inflection"] = None
        return rows
    infl = find_inflection(list(EQ1_BATCHES), curve)
    print(f"phase 12: find_inflection over the measured eager TKLQT of the "
          f"filtered profiles "
          f"{[round(t, 1) for t in curve]} us at batch "
          f"{list(EQ1_BATCHES)}: {infl}"
          + (" (no GPU-bound batch up to 4: every step is CPU-bound)"
             if infl is None else ""))
    rows["inflection"] = infl
    return rows


def phase_plans(cfg, rcfg, eager: dict, jit_done: dict) -> tuple:
    """Phase 12: the cells under the launch plans of ``PLAN_CELLS``,
    checked and traced; then the measured Eq. 1 timeline.  Returns
    ({cell: {plan: numbers}}, {"cell:plan": launch counts})."""
    t0 = time.perf_counter()
    rows, counts, params, keep = {}, {}, None, None
    for cell, plans in PLAN_CELLS.items():
        arch, _, prefill = JIT_CELLS[cell]
        c = cfg if arch == "smollm" else rcfg
        rows[cell] = {}
        for plan in plans:
            eng, done, rep, counts[f"{cell}:{plan}"] = serve_cell(
                cell, c, params, plan, 12)
            check_launches(cell, plan, eng, rep)
            if plan == "fused":
                check_fused(cell, eng, done, jit_done[cell])
            trace = phase_trace(eng, f"phase 12 {cell} {plan} trace",
                                prefill)
            r = rows[cell][plan] = plan_row(rep, trace, eng)
            if plan == "auto":
                r["auto_candidates"] = auto_candidates(eng)
            print_row(12, cell, plan, r)
            print(f"  {cell} {plan}: dispatches per prefill "
                  f"{r['prefill_dispatches']}; launches per decode step "
                  f"{r['launches_per_step']}, per prefill "
                  f"{r['launches_per_prefill']:.0f}; rule hits per call "
                  f"{(r['rule_hits_per_call'] or [{}])[0]}; modeled TKLQT "
                  f"{r['modeled_tklqt_us']:.1f} us a decode step "
                  f"(Intel+H100); the decode step's trace "
                  f"{r['trace_nodes']} nodes in {r['trace_s']:.2f} s; "
                  f"planning {r['plan_s']:.2f} s")
            nxt = eng.params if cell == "paged_bf16" else None
            if cell == "contiguous":
                keep = eng.params
            del eng
            torch.cuda.empty_cache()
        params = nxt
    disp = {p: rows["contiguous"][p]["dispatches"]
            for p in PLAN_CELLS["contiguous"]}
    disp["eager"] = eager["contiguous"][0]["dispatches_per_decode_step"]
    # auto takes the lowest modeled TKLQT of the cost-aware partition and
    # every chain(L).  At full width a chain wins, as it does for the
    # reference's planner over its own trace (tests/test_torch_runtime.py,
    # test_auto_picks_the_plan_kind_the_reference_picks_at_full_width),
    # and then auto is that chain: equal dispatches, from a chain only
    chosen = rows["contiguous"]["auto"]["auto_candidates"][0]
    if not (disp["eager"] > disp["chain"] >= disp["auto"]
            >= disp["whole_graph"] == 1) or (
            disp["chain"] == disp["auto"] and chosen["strategy"] != "chain"):
        fail(f"dispatches per decode step out of order: {disp}, auto chose "
             f"{chosen}")
    steps = {p: rows["contiguous"][p]["launches_per_step"]
             for p in ("whole_graph", "chain", "auto")}
    if len({json.dumps(v, sort_keys=True) for v in steps.values()}) != 1:
        fail(f"launches per decode step differ across plans: {steps}")
    print(f"phase 12: contiguous dispatches per decode step {disp} (chain "
          f"{'>' if disp['chain'] > disp['auto'] else '=='} auto); launches"
          f" per decode step equal under whole_graph, chain and auto")
    eq1 = phase_eq1(cfg, keep)
    del keep
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 12: {secs:.1f} s")
    print("phase 12: " + json.dumps({"rows": rows, "eq1": eq1,
                                     "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 13
LLAMA = "llama-3.2-1b"
# cell -> serve flags; the contiguous cell's prefill is traced too
LLAMA_CELLS = {"llama_contiguous": [], "llama_paged_bf16": PAGED}


def f32_logits_check(cfg, phase: int, seed: int, biases=False,
                     steps: int = 3) -> list:
    """``kernel_vs_plain_logits`` of ``cfg`` in f32 with random weights:
    a MAX_BATCH x BUCKET prefill and ``steps`` decode steps.  Returns the
    kernels' logits of each call."""
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = model_params(cfg32, seed, biases)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, BUCKET)))
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (MAX_BATCH, 1)))
            for _ in range(steps)]
    label = f"phase {phase} {cfg.name} f32 logits"
    err, got = kernel_vs_plain_logits(cfg32, params, prompt, toks, label)
    print(f"phase {phase}: {cfg.name} f32 at full width, {cfg.n_layers} "
          f"layers, window {cfg.sliding_window}: prefill ({MAX_BATCH} x "
          f"{BUCKET}) + {steps} decode steps: max |kernel - plain| logits "
          f"{err:.3g} (<= {LOGIT_TOL_F32}), argmax agrees")
    del params
    torch.cuda.empty_cache()
    return got


def model_params(cfg, seed: int, biases: bool = False) -> dict:
    """Random weights drawn on the card; with ``biases`` a qkv bias drawn
    non-zero (the init's zeros would hide a dropped one)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = init_params(cfg, gen, device=DEV)
    if biases:
        for blk in params["blocks"]:
            for b in ("bq", "bk", "bv"):
                t = blk["mixer"][b]
                t.copy_(torch.randn(t.shape, generator=gen, device=DEV)
                        * 0.5)
    return params


def serve_eager_then_jit(cell, cfg, extra, phase, prefill, params=None):
    """A cell under eager, then jit (``serve_flags``, or with ``params`` an
    engine on them over ``serve.make_requests``), each checked (launches,
    jit: one dispatch and eager's tokens up to near ties) and its decode
    step traced.  Returns ({plan: row}, jit's finished requests, jit's
    launch counts, eager's)."""
    runs = {}
    for plan in ("eager", "jit"):
        if params is None:
            eng, done, rep, counts = serve_flags(cfg, extra, plan, phase)
        else:
            eng, done, rep, counts = serve_engine(cfg, params, plan, phase)
        check_launches(cell, plan, eng, rep)
        if plan == "jit":
            erep, edone = runs["eager"][1:3]
            check_jit(cell, rep, erep, done, edone, eng.params, cfg)
        trace = phase_trace(eng, f"phase {phase} {cell} {plan} trace",
                            prefill)
        runs[plan] = (cell_row(rep, trace), rep, done, counts)
        print_row(phase, cell, plan, runs[plan][0])
        del eng
        torch.cuda.empty_cache()
    return ({p: r[0] for p, r in runs.items()}, runs["jit"][2],
            runs["jit"][3], runs["eager"][3])


def serve_engine(cfg, params, plan: str, phase: int) -> tuple:
    """``ServeEngine`` on ``params`` under ``plan`` over the serve CLI's
    requests (warmup + measured run), counted as ``serve_cell`` does."""
    eng = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      plan=plan, device=DEV)
    eng.run(serve.make_requests(N_REQ, cfg.vocab_size, 16))
    eng.reset()
    reqs = serve.make_requests(N_REQ, cfg.vocab_size, 16)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rep = serve.report(eng, done, wall)
    print(f"phase {phase}: ServeEngine({cfg.name}, {cfg.n_layers} layers, "
          f"plan {plan}) over the serve CLI's {N_REQ} requests")
    print(f"  report {json.dumps(rep)}")
    if len(done) != N_REQ or any(r.status != "done" or len(r.generated)
                                 != 16 for r in done):
        fail(f"phase {phase} {cfg.name} {plan}: finished {len(done)} of "
             f"{N_REQ} requests")
    return eng, done, rep, counts


def phase_llama() -> tuple:
    """Phase 13: Llama-3.2-1B, the paper's headline model, at full width
    and depth: f32 logits kernels against plain versions, then bf16
    serving under eager and jit on the contiguous cache and the paged
    pool, then fused on the contiguous cache.  Returns ({cell: {plan:
    numbers}}, {cell:plan: launch counts})."""
    t0 = time.perf_counter()
    cfg = get_config(LLAMA)
    f32_logits_check(cfg, 13, 13)
    rows, counts, jit_done = {}, {}, {}
    for cell, extra in LLAMA_CELLS.items():
        rows[cell], jit_done[cell], counts[f"{cell}:jit"], \
            counts[f"{cell}:eager"] = serve_eager_then_jit(
                cell, cfg, extra, 13, prefill=cell == "llama_contiguous")
    cell = "llama_contiguous"
    eng, done, rep, counts[f"{cell}:fused"] = serve_flags(cfg, [], "fused",
                                                          13)
    check_launches(cell, "fused", eng, rep)
    check_fused(cell, eng, done, jit_done[cell])
    trace = phase_trace(eng, f"phase 13 {cell} fused trace")
    r = rows[cell]["fused"] = plan_row(rep, trace, eng)
    print_row(13, cell, "fused", r)
    print(f"  {cell} fused: tokens equal jit's in {N_REQ}/{N_REQ} requests; "
          f"rule hits per call {r['rule_hits_per_call']}; modeled TKLQT "
          f"{r['modeled_tklqt_us']:.1f} us a decode step (Intel+H100)")
    del eng
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 13: {secs:.1f} s")
    print("phase 13: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 14
# decoder -> layers served (None: full depth); Gemma-2's two are one local
# and one global layer
PHASE14_DECODERS = {"internlm2-20b": 2, "codeqwen1.5-7b": 2,
                    "gemma2-27b": 2, "gpt2": None}
PHASE14_ENCODERS = ("bert-base-uncased", "xlm-roberta-base")
GEMMA_CUT_WINDOW = 8       # the f32 check's window, so it bites in 19 tokens


def window_in_graphs(cfg, seed: int) -> None:
    """``cfg`` in f32 with its window cut to GEMMA_CUT_WINDOW under
    ``plan="jit"``: a BUCKET-token prefill into each slot and one batched
    decode step, each a CUDA graph replay, give the plain forward's logits
    with the cut window within LOGIT_TOL_F32; the plain forward with the
    full window parts from them by more (with random tied embeddings the
    greedy tokens barely depend on attention, so the logits are held)."""
    cut = cfg.replace(sliding_window=GEMMA_CUT_WINDOW,
                      param_dtype="float32", compute_dtype="float32")
    params = model_params(cut, seed, cfg.qkv_bias)
    eng = ServeEngine(cut, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      plan="jit", device=DEV)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (MAX_BATCH, BUCKET),
                           dtype=np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (MAX_BATCH, 1), dtype=np.int32)
    got = []
    for slot in range(MAX_BATCH):
        logits, eng.cache = eng.backend.prefill(
            eng.cache, torch.from_numpy(prompts[slot:slot + 1]), slot,
            BUCKET)
        got.append(logits[0].clone())      # the graph's output buffer
    logits, eng.cache = eng.backend.decode(eng.cache, torch.from_numpy(nxt),
                                           np.full(MAX_BATCH, BUCKET))
    if eng.backend.last.dispatches != 1 or not eng.backend.graph_stats \
            .captured:
        fail(f"phase 14 {cfg.name} window {GEMMA_CUT_WINDOW}: the decode "
             f"step took {eng.backend.last.dispatches} dispatches, "
             f"{eng.backend.graph_stats.captured} graphs captured")
    got += list(logits.clone())
    seqs = [[int(t) for t in p] for p in prompts]
    seqs += [p + [int(t[0])] for p, t in zip(seqs, nxt)]
    err = bite = 0.0
    for i, (g, toks) in enumerate(zip(got, seqs)):
        err = max(err, compare_logits(
            g, plain_logits(params, cut, toks), LOGIT_TOL_F32,
            f"phase 14 {cfg.name} window {GEMMA_CUT_WINDOW} jit call {i}"))
        full = plain_logits(params, cut.replace(
            sliding_window=cfg.sliding_window), toks)
        bite = max(bite, (g - full).abs().max().item())
    if not bite > LOGIT_TOL_F32:
        fail(f"phase 14 {cfg.name}: the jit logits with the window of "
             f"{GEMMA_CUT_WINDOW} are within {bite:.3g} of the full "
             "window's: it did not bite inside the graphs")
    print(f"phase 14: {cfg.name} f32 under jit, window "
          f"{GEMMA_CUT_WINDOW}: {MAX_BATCH} prefills ({BUCKET} tokens) and "
          f"one decode step, graph replays ({eng.backend.graph_stats.captured}"
          f" graphs): max |jit - plain| logits {err:.3g} (<= "
          f"{LOGIT_TOL_F32}); the full window's plain logits part by "
          f"{bite:.3g}")
    del eng, params
    torch.cuda.empty_cache()


def phase_others() -> tuple:
    """Phase 14: InternLM2-20B, CodeQwen1.5-7B (qkv biases drawn non-zero)
    and Gemma-2-27B at full width and 2 layers, GPT-2 at full depth: f32
    logits kernels against plain versions (Gemma-2 also with its window cut
    to GEMMA_CUT_WINDOW, so that it bites), then a bf16 engine under eager
    and jit, jit's tokens against eager's (Gemma-2 again with the cut
    window, then ``window_in_graphs``); BERT and XLM-R at full depth:
    one f32 non-causal forward of MAX_BATCH x BERT_SEQ tokens, kernels
    against plain versions.  Each model is freed before the next is
    built.  Returns ({cell: {plan: numbers}}, {cell:plan: launch
    counts})."""
    t0 = time.perf_counter()
    rows, counts = {}, {}
    for i, (name, layers) in enumerate(PHASE14_DECODERS.items()):
        base = get_config(name)
        cfg = base.replace(n_layers=layers) if layers else base
        biases = cfg.qkv_bias
        full = f32_logits_check(cfg, 14, 20 + i, biases)
        if cfg.sliding_window:
            cut = f32_logits_check(
                cfg.replace(sliding_window=GEMMA_CUT_WINDOW), 14, 20 + i,
                biases)
            bite = max((a - b).abs().max().item() for a, b in zip(cut, full))
            if not bite > LOGIT_TOL_F32:
                fail(f"phase 14 {name}: the window of {GEMMA_CUT_WINDOW} "
                     f"moved the logits by {bite:.3g} only")
            print(f"  the window of {GEMMA_CUT_WINDOW} bites: max |logits "
                  f"(window {GEMMA_CUT_WINDOW}) - logits (window "
                  f"{cfg.sliding_window})| {bite:.3g}")
        del full
        params = model_params(cfg, 30 + i, biases)
        rows[name], done, counts[f"{name}:jit"], counts[f"{name}:eager"] = \
            serve_eager_then_jit(name, cfg, None, 14, prefill=True,
                                 params=params)
        if cfg.sliding_window:
            # the full window never bites under MAX_LEN: serve the cut one
            # too, so a biting window runs inside the captured graphs
            cell = f"{name}_window{GEMMA_CUT_WINDOW}"
            rows[cell], _, counts[f"{cell}:jit"], \
                counts[f"{cell}:eager"] = serve_eager_then_jit(
                    cell, cfg.replace(sliding_window=GEMMA_CUT_WINDOW),
                    None, 14, prefill=False, params=params)
        del params, done
        torch.cuda.empty_cache()
        if cfg.sliding_window:
            window_in_graphs(cfg, 50 + i)
        torch.cuda.empty_cache()
    for i, name in enumerate(PHASE14_ENCODERS):
        cfg = get_config(name)
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        params = model_params(cfg32, 40 + i)
        prompt = torch.from_numpy(np.random.default_rng(40 + i).integers(
            0, cfg.vocab_size, (MAX_BATCH, BERT_SEQ)))
        kernels.reset_launch_counts()
        err, _ = kernel_vs_plain_logits(cfg32, params, prompt, None,
                                        f"phase 14 {name} f32 logits")
        counts[f"{name}:forward"] = kernels.launch_counts()
        want = {"flash_attention": cfg.n_layers,
                "rmsnorm_matmul": cfg.n_layers,
                "residual_rmsnorm": cfg.n_layers + 1}
        got = {k: v for k, v in counts[f"{name}:forward"].items() if v}
        if got != want:
            fail(f"phase 14 {name}: launches {got} != {want}")
        print(f"phase 14: {name} f32 at full width and depth ("
              f"{cfg.n_layers} layers), one non-causal forward of "
              f"{MAX_BATCH} x {BERT_SEQ} tokens: max |kernel - plain| logits "
              f"{err:.3g} (<= {LOGIT_TOL_F32}), argmax agrees; launches {got}")
        del params
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 14: {secs:.1f} s")
    print("phase 14: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ main
# which main path (its jit run, phase 11) each kernel's ``launches`` is
# read from
MAIN_PATH = {"decode_attention": "contiguous",
             "flash_attention": "contiguous",
             "residual_rmsnorm": "contiguous",
             "rmsnorm_matmul": "contiguous",
             "paged_decode_attention": "paged_bf16",
             "paged_decode_attention_quant": "paged_int8_pressure",
    "rmsnorm": "rwkv",
    "wkv6": "rwkv"}


def main() -> None:
    t0 = time.perf_counter()
    cfg, rcfg = get_config(ARCH), get_config(RWKV_ARCH)
    phase_build()
    rows = phase_kernels(cfg, rcfg)
    phase_dispatch_cost(cfg)
    phase_logits_f32(cfg)
    eager_counts, eager = {}, {}
    eager_counts["contiguous"], rep, eng, done = phase_serve(cfg, 4)
    eager["contiguous"] = (rep, done, phase_trace(eng, "phase 5",
                                                  prefill=True))
    del eng
    torch.cuda.empty_cache()
    eager_counts["paged_bf16"], rep, eng, done = phase_serve(cfg, 6, PAGED)
    eager["paged_bf16"] = (rep, done, phase_trace(eng, "phase 6 trace"))
    eager_counts["paged_int8_pressure"], rep, eng, done = phase_pool_pressure(
        cfg, eng.params)
    eager["paged_int8_pressure"] = (rep, done,
                                    phase_trace(eng, "phase 7 trace"))
    del eng
    torch.cuda.empty_cache()
    phase_logits_rwkv(rcfg)
    eager_counts["rwkv"], rep, eng, done = phase_serve(rcfg, 9)
    check_rwkv_streams(rcfg)
    eager["rwkv"] = (rep, done, phase_trace(eng, "phase 10", prefill=True))
    del eng
    torch.cuda.empty_cache()
    _, jit_done, path_counts = phase_jit(cfg, rcfg, eager)
    _, plan_counts = phase_plans(cfg, rcfg, eager, jit_done)
    _, llama_counts = phase_llama()
    _, other_counts = phase_others()
    print(f"chip_smoke: phases 1-14 in {time.perf_counter() - t0:.1f} s")

    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = dict(rows[name])
        for key, sub in rows.items():          # e.g. "rmsnorm_matmul[prefill]"
            if key.startswith(name + "["):
                row[key[len(name) + 1:-1]] = sub
        launches = path_counts[MAIN_PATH[name]][name]
        if launches <= 0:
            fail(f"{name} was not launched on its main path "
                 f"({MAIN_PATH[name]})")
        by_path = {f"{p}:jit": c[name] for p, c in path_counts.items()}
        by_path.update({f"{p}:eager": c[name]
                        for p, c in eager_counts.items()})
        by_path.update({p: c[name] for p, c in plan_counts.items()})
        by_path.update({p: c[name] for p, c in llama_counts.items()})
        by_path.update({p: c[name] for p, c in other_counts.items()})
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "launches_by_path": by_path, **row})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
