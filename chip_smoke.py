"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before a result is printed):

  1. build the hand-written kernels from ``src/repro_torch/csrc`` with nvcc
     for sm_90a, and time an empty kernel's launch;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (SmolLM-360M, max_batch 4, max_len 128, 16-token prefill
     bucket; the norms at both the decode rows (4 x 1) and a slot's
     prefill rows (1 x 16)) in f32 and bf16, and time kernel, plain
     version and, where one PyTorch call computes the same function, that
     call;
  3. full-width SmolLM-360M logits in f32, kernels against plain versions,
     for a prefill and batched decode steps;
  4. the main path: ``repro_torch.launch.serve`` serving full-width
     SmolLM-360M in bf16 (8 requests, max_batch 4), with every kernel's
     launch count reset just before and read just after;
  5. a profiler trace of decode steps (device time by kernel).

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
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
LOGIT_TOL_F32 = 1e-3               # full model, f32, other summation order
LOGIT_TOL_BF16 = 0.25              # full model, bf16 rounding at other points
ARCH, MAX_BATCH, MAX_LEN, BUCKET, N_REQ = "smollm-360m", 4, 128, 16, 8
KERNEL_INFO = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:228"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:91"),
    "residual_rmsnorm": ("src/repro_torch/csrc/residual_rmsnorm.cu",
                         "src/repro/kernels/fused/residual_rmsnorm/"
                         "kernel.py:59"),
    "rmsnorm_matmul": ("src/repro_torch/csrc/rmsnorm_matmul.cu",
                       "src/repro/kernels/fused/rmsnorm_matmul/kernel.py:53"),
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
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref                                   # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused.residual_rmsnorm.ref import \
    residual_rmsnorm_ref                                   # noqa: E402
from repro_torch.kernels.fused.rmsnorm_matmul.ref import \
    rmsnorm_matmul_ref                                     # noqa: E402
from repro_torch.launch import serve                       # noqa: E402
from repro_torch.models import forward, init_params, make_cache  # noqa: E402

DEV = torch.device("cuda", 0)
PLAINS = {"decode_attention": decode_attention_ref,
          "flash_attention": attention_ref,
          "residual_rmsnorm": residual_rmsnorm_ref,
          "rmsnorm_matmul": rmsnorm_matmul_ref}


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
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
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
def main_path_cases(cfg, dtype):
    """Inputs of each kernel at the shapes the main path gives it, with the
    bytes and flops the call needs on these inputs.  A key ``name[variant]``
    is another call of kernel ``name``: without a residual, or at a slot's
    prefill rows (1, BUCKET, d), where ``rmsnorm_matmul`` runs two row
    tiles."""
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
    return {
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
            bytes=(2 * b * d + d + d * f + b * f) * es,
            flops=2 * b * d * f + 4 * b * d),
        "rmsnorm_matmul[prefill]": dict(
            call=lambda: kernels.rmsnorm_matmul(xp, w, wq),
            plain=lambda: rmsnorm_matmul_ref(xp, w, wq),
            library=None,
            bytes=(2 * BUCKET * d + d + d * f + BUCKET * f) * es,
            flops=2 * BUCKET * d * f + 4 * BUCKET * d),
    }


def phase_kernels(cfg) -> dict:
    """Kernel vs plain version at main-path shapes; returns the bf16 rows
    (with the f32 error), keyed as the cases are."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, c in main_path_cases(cfg, dtype).items():
            out, ref = c["call"](), c["plain"]()
            err = max_err(out, ref)
            bound = rel_bound(ref, dtype)
            if not err <= bound:
                fail(f"{name} {dtype}: max |kernel - plain| {err:.3g} > "
                     f"{bound:.3g}")
            k_ms, k_host = time_ms(c["call"])
            p_ms, p_host = time_ms(c["plain"])
            lib_ms = time_ms(c["library"])[0] if c["library"] else None
            b_ms, by = bound_ms(c["bytes"], c["flops"], dtype)
            lib = "null" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
            print(f"phase 2: {name:38s} {str(dtype)[6:]:9s} max_err "
                  f"{err:.3g} (<= {bound:.3g})  device: kernel "
                  f"{k_ms * 1e3:.2f} us  plain {p_ms * 1e3:.2f} us  library "
                  f"{lib}  bound {b_ms * 1e3:.4f} us ({by});  host: kernel "
                  f"{k_host * 1e3:.2f} us  plain {p_host * 1e3:.2f} us")
            row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
                       host_ms=k_host, plain_host_ms=p_host)
            if dtype == torch.float32:
                rows.setdefault(name, {})["max_abs_err_f32"] = err
            else:
                rows.setdefault(name, {}).update(row)
    return rows


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


def phase_logits_f32(cfg) -> None:
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(cfg32, gen, device=DEV)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MAX_BATCH, BUCKET)).astype(np.int64))
    steps = [rng.integers(0, cfg.vocab_size, (MAX_BATCH, 1)) for _ in range(3)]
    lens0 = np.array([16, 9, 12, 5])       # ragged rows, as after prefills
    out = {}
    for mode in ("kernel", "plain"):
        ctx = plain_kernels() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            cache = make_cache(cfg32, MAX_BATCH, MAX_LEN, device=DEV)
            logits, cache = forward(params, prompt, cfg32, cache=cache)
            got = [logits]
            for i, tok in enumerate(steps):
                lg, cache = forward(params, torch.from_numpy(tok), cfg32,
                                    cache=cache, lengths=lens0 + i)
                got.append(lg)
            out[mode] = got
    errs = [compare_logits(a, b, LOGIT_TOL_F32, f"f32 logits call {i}")
            for i, (a, b) in enumerate(zip(out["kernel"], out["plain"]))]
    print(f"phase 3: full-width {cfg.name} f32 ({cfg.n_layers} layers), "
          f"prefill (4 x {BUCKET}) + 3 decode steps: max |kernel - plain| "
          f"logits {max(errs):.3g} (<= {LOGIT_TOL_F32}), argmax agrees")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 4
def phase_serve(cfg) -> tuple:
    argv = ["--arch", ARCH, "--requests", str(N_REQ), "--max-batch",
            str(MAX_BATCH), "--max-len", str(MAX_LEN), "--device", "cuda"]
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        eng, done = serve.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"phase 4: serve {' '.join(argv)}")
    print(f"  report {json.dumps(rep)}")
    print(f"  launches (warmup + measured run) {counts}")
    L = cfg.n_layers
    st = eng.stats
    if len(done) != N_REQ or any(r.status != "done" for r in done):
        fail(f"serve finished {len(done)} of {N_REQ} requests")
    for r in done:
        if len(r.generated) != 16 or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"request {r.rid} generated {r.generated}")
    want_step = {"decode_attention": L, "flash_attention": 0,
                 "residual_rmsnorm": L + 1, "rmsnorm_matmul": L}
    if st.kernel_launches_per_decode_step != want_step:
        fail(f"launches per decode step {st.kernel_launches_per_decode_step}"
             f" != {want_step}")
    if st.prefill_kernel_launches != st.prefills * (3 * L + 1):
        fail(f"prefill launches {st.prefill_kernel_launches} != "
             f"{st.prefills} x {3 * L + 1}")
    runs = 2                               # warmup + measured, same schedule
    want = {"decode_attention": runs * st.decode_steps * L,
            "flash_attention": runs * st.prefills * L,
            "residual_rmsnorm": runs * (st.decode_steps + st.prefills)
            * (L + 1),
            "rmsnorm_matmul": runs * (st.decode_steps + st.prefills) * L}
    if counts != want:
        fail(f"launch counts {counts} != {want}")

    # first tokens against the plain versions on the same bf16 weights
    prompts = np.zeros((N_REQ, BUCKET), np.int64)
    for r in done:
        prompts[r.rid, :len(r.prompt)] = r.prompt
    first = torch.tensor([r.generated[0] for r in
                          sorted(done, key=lambda r: r.rid)], device=DEV)
    with plain_kernels():
        logits, _ = forward(eng.params, torch.from_numpy(prompts), cfg)
    plain = logits[:, len(done[0].prompt) - 1]
    top2 = plain.topk(2, dim=-1).values
    flips = (plain.argmax(-1) != first) & (top2[:, 0] - top2[:, 1]
                                           >= LOGIT_TOL_BF16)
    if flips.any():
        fail(f"{int(flips.sum())} served first tokens disagree with the "
             f"plain bf16 forward where its top-2 gap >= {LOGIT_TOL_BF16}")
    agree = int((plain.argmax(-1) == first).sum())
    print(f"  served first tokens agree with the plain bf16 forward: "
          f"{agree}/{N_REQ}")
    return counts, rep, eng


# ------------------------------------------------------------------ phase 5
def phase_trace(eng) -> None:
    """Decode-step wall time, and device time by kernel from torch.profiler
    (kernels run in order on one stream, so their sum is the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, eng.cfg.vocab_size,
                                         (MAX_BATCH, 1)))
    lens = np.array([20, 20, 20, 20])
    steps = 10

    def run():
        for _ in range(steps):
            logits, _ = eng.backend.decode(eng.cache, toks, lens)
            logits.cpu()                   # the engine's host argmax sync

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print(f"phase 5: decode step wall {wall_ms:.3f} ms; the profiler "
              "reported no device events: device time not measured")
        return
    by = {}
    for e in kern:
        t, n = by.get(e.name, (0.0, 0))
        by[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(t for t, _ in by.values()) / steps / 1e3
    n_kern = sum(n for _, n in by.values()) / steps
    print(f"phase 5: decode step (batch {MAX_BATCH}, kv len 20): wall "
          f"{wall_ms:.3f} ms/step unprofiled; profiled: device busy "
          f"{busy_ms:.3f} ms/step ({busy_ms / wall_ms:.1%} of the unprofiled "
          f"wall), {n_kern:.0f} device kernels/step")
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / steps:9.1f} us/step {n / steps:6.1f}x  {name[:90]}")


# ------------------------------------------------------------------ main
def main() -> None:
    cfg = get_config(ARCH)
    phase_build()
    rows = phase_kernels(cfg)
    phase_logits_f32(cfg)
    counts, rep, eng = phase_serve(cfg)
    phase_trace(eng)

    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = dict(rows[name])
        for key, sub in rows.items():          # e.g. "rmsnorm_matmul[prefill]"
            if key.startswith(name + "["):
                row[key[len(name) + 1:-1]] = sub
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        **row})
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
