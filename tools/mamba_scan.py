"""The Mamba layer's two scans on the card: the per-step scan and the
two-level scan that ``layers/mamba.py`` runs for a segment longer than
``TIME_CHUNK`` steps.

    PYTHONPATH=src python tools/mamba_scan.py [--out FILE]

(a) A prefill through one whole-width Jamba-1.5-Large Mamba layer
(``mamba_fwd``, d_model 8192, d_inner 16384, bf16 weights drawn from a
seed), batch 1, at S = 4096 and 32768, with each scan: ms a call (the
median of the timed calls, synchronized) and the peak of memory the call
allocates above what it was given, and the largest difference between
the two outputs over the largest output.  (b) The scan alone, forward
and backward, at the shape one rank of the dry run's 16 x 16 mesh gives
it in Jamba's ``train_4k`` (B 16, S 4096, d_inner 16384 / 16, d_state
16, f32): ms and peak, and the largest gradient difference.  One JSON
line a row on stdout (and in ``--out``), after the card's name and power
limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.layers import mamba

ARCH = "jamba-1.5-large-398b"
PREFILL_S = (4096, 32768)
TRAIN = (16, 4096, 16384 // 16, 16)          # B, S, d_inner, d_state
SCANS = {"step": mamba._scan_chunk, "two_level": mamba._scan_blocks}
DEV = torch.device("cuda")


def measure(fn, reps: int) -> tuple:
    """(result of the first call, median ms of ``reps`` timed calls after
    it, peak bytes allocated above the start over all calls)."""
    dev = DEV
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) - base
    return out, sorted(times)[len(times) // 2], peak


def with_scan(name: str):
    """``mamba_fwd`` with the long-segment scan set to ``name``'s."""
    def run(params, x, cfg):
        saved = mamba._scan_blocks
        mamba._scan_blocks = SCANS[name]
        try:
            return mamba.mamba_fwd(params, x, cfg)[0]
        finally:
            mamba._scan_blocks = saved
    return run


def prefill_rows() -> list:
    cfg = get_config(ARCH)
    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mamba.mamba_init(gen, cfg, dev)
    rows = []
    for s in PREFILL_S:
        x = torch.randn(1, s, cfg.d_model, generator=gen, device=dev,
                        dtype=cfg.cdtype)
        outs = {}
        for name in SCANS:
            run = with_scan(name)
            with torch.no_grad():
                out, ms, peak = measure(lambda: run(params, x, cfg), 2)
            outs[name] = out.float()
            rows.append({"row": "prefill", "scan": name, "B": 1, "S": s,
                         "d_model": cfg.d_model, "ms": ms,
                         "peak_gb": peak / 1e9})
            del out
            torch.cuda.empty_cache()
        err = float((outs["two_level"] - outs["step"]).abs().max())
        rows[-1]["max_abs_diff_rel"] = err / float(outs["step"].abs().max())
        del outs, x
    return rows


def train_rows() -> list:
    b, s, di, ds = TRAIN
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(1)
    xc = torch.randn(b, s, di, generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, generator=g, device=dev) - 4.6)
    bm, cm = (torch.randn(b, s, ds, generator=g, device=dev)
              for _ in range(2))
    a = -torch.arange(1, ds + 1, dtype=torch.float32,
                      device=dev).expand(di, ds)
    h0 = torch.zeros(b, di, ds, device=dev)
    dy = torch.randn(b, s, di, generator=g, device=dev)
    rows, grads = [], {}
    for name, scan in SCANS.items():
        ins = [t.clone().requires_grad_() for t in (xc, dt, bm, cm)]

        def step():
            _, ys = scan(h0, tuple(ins), a)
            return torch.autograd.grad(ys, ins, dy)
        got, ms, peak = measure(step, 1)
        grads[name] = got
        rows.append({"row": "train_scan", "scan": name, "B": b, "S": s,
                     "d_inner": di, "d_state": ds, "ms": ms,
                     "peak_gb": peak / 1e9})
        torch.cuda.empty_cache()
    rows[-1]["max_grad_diff_rel"] = max(
        float((p - q).abs().max() / q.abs().max())
        for p, q in zip(grads["two_level"], grads["step"]))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/mamba_scan.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rows = prefill_rows() + train_rows()
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
