"""Serving launcher: the continuous-batching engine over synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 8 --max-batch 4

Counterpart of ``repro.launch.serve`` for the flags the port supports.
Weights are random, drawn on the device from a generator seeded 0; prompts
are 12 tokens from numpy's generator seeded 0, as in the reference.  Runs
on the GPU by default and raises without one; ``--device cpu`` runs the
plain PyTorch path.  Prints one JSON line: the fields ``EngineStats``
fills, the device, and ``kernel_launches_per_decode_step`` of the
hand-written kernels.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.models import init_params
from repro_torch.telemetry.metrics import percentile


def make_requests(n: int, vocab: int, max_new: int) -> list:
    rng = np.random.default_rng(0)
    return [Request(i, prompt=[int(t) for t in rng.integers(0, vocab, 12)],
                    max_new_tokens=max_new) for i in range(n)]


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def report(eng: ServeEngine, done: list, wall_s: float) -> dict:
    """The JSON report of one measured run."""
    st = eng.stats
    occ = st.slot_occupancy
    ttft = list(st.ttft_s.values())
    itl = st.itl_samples_s
    return {
        "arch": eng.cfg.name,
        "device": device_name(eng.backend.device),
        "requests": sum(1 for r in done if r.status == "done"),
        "rejected": st.rejected,
        "plan": st.plan,
        "cache": "contiguous",
        "slot_occupancy": {"mean": float(np.mean(occ)) if occ else 0.0,
                           "peak": int(max(occ)) if occ else 0},
        "tokens_out": st.tokens_out,
        "prefills": st.prefills,
        "decode_steps": st.decode_steps,
        "wall_s": wall_s,
        "tok_per_s": st.tokens_out / wall_s if wall_s > 0 else 0.0,
        "mean_ttft_ms": st.mean_ttft_s * 1e3,
        "p50_ttft_ms": percentile(ttft, 50) * 1e3 if ttft else 0.0,
        "mean_itl_ms": st.mean_itl_s * 1e3,
        "p50_itl_ms": percentile(itl, 50) * 1e3 if itl else 0.0,
        "p99_itl_ms": percentile(itl, 99) * 1e3 if itl else 0.0,
        "mean_decode_step_ms": (float(np.mean(st.step_times_s)) * 1e3
                                if st.step_times_s else 0.0),
        "measured_launch_tax_per_step_us": st.launch_tax_per_step_s * 1e6,
        "measured_launch_tax_per_decode_step_us":
            st.launch_tax_per_decode_step_s * 1e6,
        "kernel_launches_per_decode_step": st.kernel_launches_per_decode_step,
        "prefill_kernel_launches": st.prefill_kernel_launches,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup pass; measured fields then include "
                         "the kernels' first build and load")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_len=args.max_len, device=dev)
    if not args.no_warmup:
        eng.run(make_requests(args.requests, cfg.vocab_size, args.max_new))
        eng.reset()
    reqs = make_requests(args.requests, cfg.vocab_size, args.max_new)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    wall = time.perf_counter() - t0
    print(json.dumps(report(eng, done, wall)))
    return eng, done


if __name__ == "__main__":
    main()
