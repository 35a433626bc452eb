"""Training launcher: the fault-tolerant Trainer on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 30 --batch 4 --seq 64

Counterpart of ``repro.launch.train`` with its flags (``--arch --reduced
--steps --batch --seq --lr --ckpt-dir --ckpt-every --fail-at``) plus
``--device`` (``cuda`` by default; it raises without a GPU, ``cpu`` runs
the kernels' plain versions).  A run resumes from the newest checkpoint in
``--ckpt-dir``; ``--fail-at N`` crashes after step N's checkpoint, and the
next run resumes there.  It prints the reference's one JSON line: arch,
steps, loss_first, loss_last, wall_s, stragglers.  An RWKV-6 stack is
refused (its ``wkv6`` op has no backward yet).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.training.loop import TrainConfig, Trainer, default_ckpt_dir
from repro_torch.training.optim import OptConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulated failure (restart resumes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    data_cfg = DataConfig(batch=args.batch, seq_len=args.seq,
                          vocab_size=cfg.vocab_size)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at)
    oc = OptConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5)
    out = Trainer(cfg, data_cfg, tc, oc, device=args.device).run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    line = {"arch": cfg.name, "steps": out["final_step"],
            "loss_first": round(first, 4), "loss_last": round(last, 4),
            "wall_s": round(out["wall_s"], 1),
            "stragglers": out["stragglers"]}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
