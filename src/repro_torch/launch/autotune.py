"""Plan autotuner launcher: characterize -> benchmark candidates -> table.

    PYTHONPATH=src python -m repro_torch.launch.autotune \\
        --arch llama-3.2-1b --scenario code-completion --batches 1,4,16 \\
        --out-dir autotune-out
    PYTHONPATH=src python -m repro_torch.launch.autotune --reduced \\
        --device cpu --scenario chatbot --batches 1,8 --requests 12

Counterpart of ``repro.launch.autotune``.  Runs the measured
characterization sweep (default plan: ``eager``, the paper's per-op
dispatch stream), classifies each batch point CPU- or GPU-bound from the
measured decode-step curve, benchmarks the region's candidate plans on
the port's live ``ServeEngine``, and writes:

  plan_table.json   the persisted winners — load with
                    ``ServeEngine(plan="autotuned", plan_table=...)``
                    or ``repro_torch.launch.serve --plan autotuned
                    --plan-table plan_table.json``
  autotune.json     full summary: per-batch candidates + the
                    characterization sweep that gated them

Weights are random, drawn on the device from a generator seeded 0.  Runs
on the GPU by default and raises without one; ``--device cpu`` runs the
plain PyTorch path.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device_model import PLATFORMS
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime.autotune import (CPU_BOUND_CANDIDATES,
                                          GPU_BOUND_CANDIDATES, autotune)
from repro_torch.workload import list_scenarios, load_workload


def print_table(table) -> None:
    """Each entry's region, candidates (fastest first, ``*`` selected)."""
    for batch, entry in sorted(table.entries.items()):
        fam = (CPU_BOUND_CANDIDATES if entry.region == "CPU-bound"
               else GPU_BOUND_CANDIDATES)
        print(f"batch={batch:<3d} {entry.region:<9s} "
              f"candidates={','.join(fam)} selected={entry.selected}")
        for c in sorted(entry.candidates,
                        key=lambda c: c.mean_decode_step_s):
            mark = "*" if c.plan == entry.selected else " "
            r = c.row()
            print(f"  {mark} {c.plan:<12s} "
                  f"step={r['mean_decode_step_us']}us "
                  f"tax={r['decode_launch_tax_us']}us "
                  f"disp/step={r['dispatches_per_decode_step']} "
                  f"fused/step={r['fused_dispatches_per_decode_step']} "
                  f"tok/s={r['tokens_per_s']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scenario", default="chatbot",
                    choices=list_scenarios())
    ap.add_argument("--batches", default="1,2,4,8",
                    help="comma-separated slot-pool sizes to autotune")
    ap.add_argument("--platform", default="Intel+H100",
                    choices=sorted(PLATFORMS))
    ap.add_argument("--characterize-plan", default="eager",
                    help="plan driving the region-detection sweep "
                         "(eager = the paper's per-op dispatch stream)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-cap", type=int, default=24)
    ap.add_argument("--output-cap", type=int, default=8)
    ap.add_argument("--time-scale", type=float, default=1.0)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--replay", default=None,
                    help="autotune over a recorded workload JSONL instead "
                         "of generating from the scenario")
    ap.add_argument("--out-dir", default="autotune-out")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    result = autotune(
        cfg, params, scenario=args.scenario,
        batches=[int(b) for b in args.batches.split(",") if b],
        platform=args.platform, characterize_plan=args.characterize_plan,
        n_requests=args.requests, seed=args.seed,
        prompt_cap=args.prompt_cap or None,
        output_cap=args.output_cap or None, time_scale=args.time_scale,
        max_len=args.max_len,
        workload=load_workload(args.replay) if args.replay else None,
        device=dev)
    print_table(result.table)

    os.makedirs(args.out_dir, exist_ok=True)
    table_path = result.table.save(
        os.path.join(args.out_dir, "plan_table.json"))
    summary_path = os.path.join(args.out_dir, "autotune.json")
    with open(summary_path, "w") as fh:
        json.dump(result.summary(), fh, indent=2, allow_nan=False)
    print(json.dumps({
        "selected": {str(b): e.selected
                     for b, e in sorted(result.table.entries.items())},
        "regions": {str(b): e.region
                    for b, e in sorted(result.table.entries.items())},
        "artifacts": {"plan_table": table_path, "summary": summary_path},
    }))
    return result


if __name__ == "__main__":
    main()
