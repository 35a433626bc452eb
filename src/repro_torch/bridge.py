"""Reference parameters -> port parameters, bit for bit.

The reference keeps parameters as a nested dict whose block leaves are
stacked on a leading superblock axis.  ``params_from_jax`` takes that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``, done by the caller:
this module never imports JAX) and returns the port's layout: the same
keys (a layer's q/k/v biases ``bq``/``bk``/``bv`` among them), with
``"blocks"`` unstacked into one dict per layer, in execution order
(superblock-major, then pattern slot: Gemma-2's local slot 0, then its
global slot 1, of each superblock).

bf16 arrays arrive with the ``ml_dtypes`` bfloat16 dtype, which
``torch.from_numpy`` rejects; they are reinterpreted through a ``uint16``
view, so no value is rounded and ``ml_dtypes`` is never imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.array(arr)          # own, writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    """Port parameters from the reference's tree of numpy arrays."""
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: tensor_from_numpy(a, dev))
           for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    out["blocks"] = [
        _map(blocks[f"slot{i}"], lambda a, sb=sb: tensor_from_numpy(a[sb], dev))
        for sb in range(cfg.n_superblocks)
        for i in range(len(cfg.block_pattern))
    ]
    return out
