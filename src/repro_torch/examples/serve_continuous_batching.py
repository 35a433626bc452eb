"""End-to-end serving: continuous batching over a small model.

    python -m repro_torch.examples.serve_continuous_batching [--device ...]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.models import init_params


def requests(vocab_size: int) -> list:
    """The 12 requests, drawn as the reference script draws them."""
    rng = np.random.default_rng(0)
    return [
        Request(i, prompt=list(rng.integers(0, vocab_size,
                                            int(rng.integers(4, 24)))),
                max_new_tokens=int(rng.integers(4, 20)))
        for i in range(12)
    ]


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = reduced(get_config("smollm-360m"), n_layers=4, d_model=128,
                  d_ff=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    engine = ServeEngine(cfg, params, max_batch=4, max_len=128, device=dev)

    t0 = time.time()
    done = engine.run(requests(cfg.vocab_size))
    dt = time.time() - t0

    stats = engine.stats
    occupancy = float(np.mean(stats.slot_occupancy))
    print(f"served {len(done)} requests, {stats.tokens_out} tokens "
          f"in {dt:.1f}s ({stats.tokens_out/dt:.1f} tok/s)")
    print(f"decode steps: {stats.decode_steps}, "
          f"mean slot occupancy {occupancy:.2f}/4")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} -> {r.generated}")
    return {"requests": len(done), "tokens_out": stats.tokens_out,
            "seconds": dt, "tok_per_s": stats.tokens_out / dt,
            "decode_steps": stats.decode_steps,
            "mean_slot_occupancy": occupancy,
            "generated": {r.rid: r.generated for r in done}}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
