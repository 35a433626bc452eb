"""Fault-tolerant training: checkpoint, simulated crash, exact resume.

    python -m repro_torch.examples.train_fault_tolerant [--device ...]
        [--ckpt-dir DIR]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.training.loop import TrainConfig, Trainer


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt")


def config() -> tuple:
    """The model and the data the example trains: (ModelConfig,
    DataConfig)."""
    cfg = reduced(get_config("smollm-360m"))
    return cfg, DataConfig(batch=4, seq_len=64, vocab_size=cfg.vocab_size)


def main(device="cuda", ckpt_dir: str | None = None) -> dict:
    dev = resolve_device(device)
    ckpt = ckpt_dir or default_ckpt_dir()
    shutil.rmtree(ckpt, ignore_errors=True)

    cfg, data = config()

    # run 1: crashes (simulated node failure) right after the step-20
    # checkpoint
    crash = None
    try:
        Trainer(cfg, data, TrainConfig(steps=40, ckpt_every=10, ckpt_dir=ckpt,
                                       fail_at_step=20), device=dev).run()
    except RuntimeError as e:
        crash = str(e)
        print(f"crashed as planned: {e}")

    # run 2: auto-resumes from step 20 and completes
    out = Trainer(cfg, data, TrainConfig(steps=40, ckpt_every=10,
                                         ckpt_dir=ckpt), device=dev).run()
    h = out["history"]
    print(f"resumed at step {h[0]['step']}, finished at {out['final_step']}; "
          f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")
    print(f"stragglers flagged: {out['stragglers']}")
    return {"crash": crash, "resumed_at": h[0]["step"],
            "final_step": out["final_step"],
            "losses": [x["loss"] for x in h],
            "stragglers": out["stragglers"]}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, emptied first (default: "
                         "repro_torch_example_ckpt in the temp directory)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
