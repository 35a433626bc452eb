"""Reproduce the paper's platform characterization on one model: TTFT vs
batch on LC (PCIe A100/H100) and CC (GH200) platform models, crossover
point, and the fusion opportunity in the CPU-bound region.

    python -m repro_torch.examples.platform_characterization [--device ...]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import SKIP
from repro_torch.device import resolve_device
from repro_torch.models import forward, init_params

BATCHES = (1, 4, 16, 64, 256)
PLATFORMS = ("Intel+H100", "AMD+A100", "GH200")


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    # full-width 4-layer GPT-2 trunk at the paper's 512-token sequence
    cfg = get_config("gpt2").replace(n_layers=4, param_dtype="float32",
                                     compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    skip = SKIP.trace(lambda p, t: forward(p, t, cfg)[0], params, tokens)

    print(f"{'batch':>6} | " + " | ".join(f"{p:>12}" for p in PLATFORMS))
    rows = {plat: [skip.report(plat, b, use_host_scale=False).il
                   for b in BATCHES] for plat in PLATFORMS}
    for i, b in enumerate(BATCHES):
        print(f"{b:>6} | " + " | ".join(f"{rows[p][i]*1e3:10.2f}ms"
                                        for p in rows))

    cp = next((b for i, b in enumerate(BATCHES)
               if rows["GH200"][i] < min(rows["Intel+H100"][i],
                                         rows["AMD+A100"][i])), None)
    penalty = rows["GH200"][0] / rows["Intel+H100"][0]
    speedup = min(rows["Intel+H100"][-1], rows["AMD+A100"][-1]) \
        / rows["GH200"][-1]
    print(f"\ncrossover (GH200 beats LC): batch {cp}")
    print(f"GH200 low-batch penalty (b=1): {penalty:.2f}x")
    print(f"GH200 speedup at b=256: {speedup:.2f}x")

    rec = skip.recommend(length=32)
    print("\nfusion opportunity (CPU-bound region): L=32 ideal speedup "
          f"{rec.speedup:.2f}x from {rec.c_fused} deterministic chains")
    return {"kernels": len(skip.trace_.kernels), "batches": list(BATCHES),
            "il_s": rows, "crossover_batch": cp,
            "gh200_penalty_b1": penalty, "gh200_speedup_b256": speedup,
            "fusion_ideal_speedup_l32": rec.speedup,
            "fusion_chains_l32": rec.c_fused}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
