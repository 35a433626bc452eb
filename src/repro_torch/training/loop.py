"""Trainer: checkpointed, fault-tolerant training loop with a straggler
watchdog and exact resume.

Counterpart of ``repro/training/loop.py``, on one device:

  * every ``ckpt_every`` steps, and at the last step, a checkpoint of the
    parameters and the optimizer state is written asynchronously
    (``checkpoint.CheckpointManager``, SHA-256 manifest);
  * on (re)start, ``latest_step`` resumes: the seekable pipeline replays
    the data stream from exactly that step;
  * a per-step wall-time watchdog flags straggling steps (z-score over a
    sliding window);
  * ``fail_at_step`` (a test hook) waits for the checkpoint, then raises,
    which proves the restart path end to end.

The default step is the reference's: ``loss_fn(remat=False)``, its
backward through the port's kernels, ``opt_update`` in place.  A step's
``dt`` ends with a ``torch.cuda.synchronize()`` on the card.
"""
from __future__ import annotations

import collections
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.training.optim import OptConfig, opt_init, opt_update
from repro_torch.tree import leaves, map_tree


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=default_ckpt_dir)
    log_every: int = 10
    seed: int = 0
    watchdog_window: int = 20
    watchdog_zscore: float = 4.0
    fail_at_step: Optional[int] = None     # test hook: simulated crash


class StragglerWatchdog:
    """Flags steps whose wall time is a z-score outlier vs a sliding
    window."""

    def __init__(self, window: int = 20, z: float = 4.0):
        self.times = collections.deque(maxlen=window)
        self.z = z
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 5:
            mu = np.mean(self.times)
            sd = np.std(self.times) + 1e-9
            if (dt - mu) / sd > self.z:
                self.flagged.append((step, dt))
                is_straggler = True
        self.times.append(dt)
        return is_straggler


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 train_cfg: TrainConfig,
                 opt_cfg: Optional[OptConfig] = None,
                 step_fn: Optional[Callable] = None, *, device="cuda"):
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.tc = train_cfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or OptConfig(total_steps=train_cfg.steps)
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir)
        self.watchdog = StragglerWatchdog(train_cfg.watchdog_window,
                                          train_cfg.watchdog_zscore)
        self.history: list[dict] = []
        self.step_fn = step_fn or self.default_step

    def default_step(self, params, opt_state, batch):
        """loss, backward, optimizer update (in place); returns (params,
        opt_state, {"loss", "lr", "grad_norm"})."""
        for p in leaves(params):
            p.grad = None
        loss, _ = loss_fn(params, batch, self.cfg, remat=False)
        loss.backward()
        grads = map_tree(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        params, opt_state, m = opt_update(self.opt_cfg, grads, opt_state,
                                          params)
        for p in leaves(params):
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), **m}

    # ------------------------------------------------------------ state
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(self.cfg, gen, device=self.device)
        return params, opt_init(self.opt_cfg, params), 0

    def restore_or_init(self):
        latest = self.ckpt.latest_step()
        params, opt_state, start = self.init_state()
        if latest is not None:
            tree = {"params": params, "opt": opt_state}
            restored = self.ckpt.restore(latest, tree)
            params, opt_state = restored["params"], restored["opt"]
            start = latest
        for p in leaves(params):
            p.requires_grad_(True)
        return params, opt_state, start

    # ------------------------------------------------------------ run
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> dict:
        params, opt_state, start = self.restore_or_init()
        pipe = Pipeline(self.data_cfg, self.cfg, start_step=start)
        t_wall = time.time()
        step = start - 1
        try:
            for step in range(start, self.tc.steps):
                batch = to_device(next(pipe), self.device)
                self._sync()
                t0 = time.time()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                self._sync()
                dt = time.time() - t0
                straggler = self.watchdog.observe(step, dt)
                self.history.append({"step": step,
                                     "loss": float(metrics["loss"]),
                                     "dt": dt, "straggler": straggler})
                if (step + 1) % self.tc.ckpt_every == 0 or \
                        step + 1 == self.tc.steps:
                    self.ckpt.save(step + 1,
                                   {"params": params, "opt": opt_state})
                if self.tc.fail_at_step is not None and \
                        step + 1 == self.tc.fail_at_step:
                    self.ckpt.wait()
                    raise RuntimeError(f"simulated failure at {step + 1}")
        finally:
            pipe.close()
            self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "final_step": step + 1,
                "history": self.history,
                "wall_s": time.time() - t_wall,
                "stragglers": self.watchdog.flagged}
