"""Fault-tolerant checkpointing: async writes and an integrity manifest.

Counterpart of ``repro/checkpoint/manager.py``, with its layout and its
failure story.  Per step:

    <dir>/step_<N:08d>/
        manifest.json   {step, leaves: {key: file, shape, dtype, sha256}}
        <key>.npy       one whole leaf (``blocks/3/mixer/wq`` ->
                        ``blocks__3__mixer__wq.npy``)
        COMMIT          written last

A step is written into ``step_<N>.tmp`` and renamed into place; a SHA-256
per leaf catches torn writes (``restore`` raises ``IOError``); a directory
without ``COMMIT`` is ignored by ``all_steps`` and ``latest_step``; only
the newest ``keep`` steps are kept.  ``save`` copies the leaves to the host
synchronously (the trainer updates its tensors in place right after) and
writes them in a background thread; ``last_save`` times the two.

The manifest is JSON (the reference writes msgpack, which the port does
not depend on).  numpy has no bfloat16: a bf16 leaf is stored as its raw
16-bit pattern (int16) and the manifest records its torch dtype name, so
it restores bit for bit.  Leaf keys are the port's own parameter paths; a
checkpoint written by the reference does not restore into the port.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import map_tree, named_leaves

# torch dtypes stored as another numpy dtype of the same width
_RAW = {torch.bfloat16: torch.int16}


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bf16 as its int16 bit pattern)."""
    t = t.detach()
    if t.dtype in _RAW:
        t = t.view(_RAW[t.dtype])
    return np.array(t.cpu().numpy(), copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the newest completed save: step, leaf bytes, seconds of the
        # host copy (synchronous) and of the write (hashes included)
        self.last_save: Optional[dict] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save
    def save(self, step: int, tree) -> None:
        t0 = time.perf_counter()
        host = {k: (_to_host(v), _dtype_name(v))
                for k, v in named_leaves(tree)}
        copy_s = time.perf_counter() - t0
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, copy_s),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, copy_s)

    def _write_async(self, step: int, host: dict, copy_s: float) -> None:
        try:
            self._write(step, host, copy_s)
        except BaseException as e:      # raised again by wait()
            self._error = e

    def _write(self, step: int, host: dict, copy_s: float) -> None:
        t0 = time.perf_counter()
        d = os.path.join(self.dir, f"step_{step:08d}")
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for key, (arr, dtype) in host.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype,
                "sha256": _sha(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        self.last_save = {"step": step,
                          "bytes": sum(a.nbytes for a, _ in host.values()),
                          "copy_s": copy_s,
                          "write_s": time.perf_counter() - t0}
        self._gc()

    def wait(self) -> None:
        """Wait for the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target, verify: bool = True):
        """A tree of ``target``'s structure read from step ``step``, each
        leaf on its target leaf's device, in its saved dtype."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        for key, leaf in named_leaves(target):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.load(os.path.join(d, meta["file"]))
            if verify and _sha(arr) != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {key!r}")
            t = torch.from_numpy(arr)
            dtype = getattr(torch, meta["dtype"])
            if dtype in _RAW:
                t = t.view(dtype)
            out.append(t.to(leaf.device))
        values = iter(out)
        return map_tree(lambda _: next(values), target)
