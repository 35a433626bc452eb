"""Quickstart: profile a model with SKIP on the aten stream, classify
PU-boundedness, mine proximity-score fusion chains, and ACTUALLY fuse them.

    python -m repro_torch.examples.quickstart [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import SKIP
from repro_torch.device import resolve_device
from repro_torch.models import forward, init_params

PLATFORMS = ("Intel+H100", "AMD+A100", "GH200")


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    # 1. a small GPT-2-family model (the layer loop is a Python loop, so
    # its kernel stream is per layer already)
    cfg = reduced(get_config("gpt2"), n_layers=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(dev)

    def fwd(params, tokens):
        return forward(params, tokens, cfg)[0]

    # 2. trace -> operator/kernel stream + measured host dispatch costs
    skip = SKIP.trace(fwd, params, tokens)
    skip.measure_host(repeats=2)
    print(f"traced {len(skip.trace_.kernels)} kernels")
    out = {"kernels": len(skip.trace_.kernels), "platforms": {}}

    # 3. simulate the paper's three platforms (Table V constants)
    for plat in PLATFORMS:
        r = skip.report(plat, batch=1)
        print(f"{plat:12s} TKLQT={r.tklqt*1e6:7.0f}us  IL={r.il*1e6:7.0f}us  "
              f"GPU idle={r.gpu_idle*1e6:7.0f}us  "
              f"queue share={r.queue_share:.2f}")
        out["platforms"][plat] = {"tklqt_s": r.tklqt, "il_s": r.il,
                                  "gpu_idle_s": r.gpu_idle,
                                  "queue_share": r.queue_share}

    # 4. CPU-bound -> GPU-bound inflection (paper Fig. 6)
    sweep, _ = skip.batch_sweep("GH200", batches=(1, 4, 16, 64, 256))
    print(f"GH200 inflection batch: {sweep.inflection_batch} "
          f"(CPU-bound region: {sweep.cpu_bound_region})")
    out["inflection_batch"] = sweep.inflection_batch
    out["cpu_bound_region"] = sweep.cpu_bound_region

    # 5. proximity-score mining (Eq. 6) and the idealized speedup (Eqs. 7-8)
    rec = skip.recommend(length=8)
    print(f"L=8 chains: {len(rec.deterministic)} deterministic (PS=1), "
          f"ideal speedup {rec.speedup:.2f}x")
    out["deterministic_chains"] = len(rec.deterministic)
    out["ideal_speedup"] = rec.speedup

    # 6. beyond the paper: apply the fusion and measure real dispatch savings
    fused = skip.fuse(length=8, repeats=2)
    print(f"chain-jit: {fused.k_eager} -> {fused.k_fused} launches, measured "
          f"host speedup {fused.measured_speedup:.2f}x (ideal "
          f"{fused.ideal_speedup:.2f}x), max |err| {fused.max_abs_err:.1e}")
    out["fuse"] = fused.row()
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
