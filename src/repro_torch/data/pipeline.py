"""Deterministic synthetic token pipeline: seekable, prefetched.

Counterpart of ``repro/data/pipeline.py``: batch i is a pure function of
(seed, i), the same numpy arrays as the reference's for every (seed, i),
so a resumed run sees the data stream it would have seen, with no loader
state to save.  A background thread keeps a small prefetch queue full so
host-side batch construction overlaps the device's step.  Batches are
numpy arrays on the host; the trainer moves them to the device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

ENCODER_SALT = 0xE5C0DE        # frame embeddings of an encoder-decoder
FRONTEND_SALT = 0x1A6E         # patch embeddings of a vision stack


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    vocab_size: int = 50257
    # synthetic structure: repeated n-grams make loss visibly learnable
    ngram: int = 8


def make_batch(cfg: DataConfig, index: int,
               model_cfg: Optional[ModelConfig] = None) -> dict:
    """Batch ``index`` of the stream: {"tokens", "labels"} int32 (B,S)
    and, for a model that needs them, "encoder_tokens" or
    "frontend_embeds" f32 (B, n_frontend_tokens, D)."""
    rng = np.random.default_rng((cfg.seed << 32) ^ index)
    base = rng.integers(0, cfg.vocab_size,
                        (cfg.batch, cfg.seq_len // cfg.ngram + 2, 1))
    tokens = (base + np.arange(cfg.ngram)[None, None, :]) % cfg.vocab_size
    tokens = tokens.reshape(cfg.batch, -1)[:, :cfg.seq_len + 1].astype(
        np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    for key, salt, wanted in (
            ("encoder_tokens", ENCODER_SALT,
             model_cfg is not None and model_cfg.n_encoder_layers),
            ("frontend_embeds", FRONTEND_SALT,
             model_cfg is not None
             and model_cfg.frontend == "vision_patches")):
        if wanted:
            rng2 = np.random.default_rng((cfg.seed << 32) ^ index ^ salt)
            batch[key] = rng2.standard_normal(
                (cfg.batch, model_cfg.n_frontend_tokens, model_cfg.d_model),
                dtype=np.float32)
    return batch


class Pipeline:
    """Prefetching iterator starting at an arbitrary step (resume)."""

    def __init__(self, cfg: DataConfig,
                 model_cfg: Optional[ModelConfig] = None,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        i = self.step
        while not self._stop.is_set():
            b = make_batch(self.cfg, i, self.model_cfg)
            while not self._stop.is_set():
                try:
                    self._q.put((i, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> dict:
        i, b = self._q.get()
        self.step = i + 1
        return b

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
