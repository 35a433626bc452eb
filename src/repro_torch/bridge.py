"""Reference parameters -> port parameters, bit for bit.

The reference keeps parameters as a nested dict whose block leaves are
stacked on a leading superblock axis.  ``params_from_jax`` takes that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``, done by the caller:
this module never imports JAX) and returns the port's layout: the same
keys (a layer's q/k/v biases ``bq``/``bk``/``bv`` among them; a MoE
layer's ``moe`` with its f32 ``router`` and (E, d, f) / (E, f, d) expert
tensors; a Mamba mixer's f32 ``A_log``, ``D`` and ``dt_b``), with
``"blocks"`` unstacked into one dict per layer, in execution order
(superblock-major, then pattern slot: Gemma-2's local slot 0, then its
global slot 1, of each superblock; Jamba's eight slots in order), and an
encoder-decoder's ``"enc_blocks"`` unstacked the same way, one dict an
encoder layer.  A cross layer's scalar f32 ``xgate``, a decoder layer's
``norm_x`` and ``xattn`` and the ``enc_norm`` cross as they are.  Every
leaf keeps its dtype.

bf16 arrays arrive with the ``ml_dtypes`` bfloat16 dtype, which
``torch.from_numpy`` rejects; they are reinterpreted through a ``uint16``
view, so no value is rounded and ``ml_dtypes`` is never imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.tree import map_tree


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.array(arr)          # own, writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _unstack(blocks: dict, n_sb: int, period: int, dev) -> list:
    """Stacked superblocks -> one dict a layer, superblock-major."""
    return [
        map_tree(lambda a, sb=sb: tensor_from_numpy(a[sb], dev),
                 blocks[f"slot{i}"])
        for sb in range(n_sb) for i in range(period)
    ]


def params_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    """Port parameters from the reference's tree of numpy arrays."""
    dev = resolve_device(device)
    stacked = ("blocks", "enc_blocks")
    out = {k: map_tree(lambda a: tensor_from_numpy(a, dev), v)
           for k, v in tree.items() if k not in stacked}
    out["blocks"] = _unstack(tree["blocks"], cfg.n_superblocks,
                             len(cfg.block_pattern), dev)
    if "enc_blocks" in tree:
        out["enc_blocks"] = _unstack(tree["enc_blocks"],
                                     cfg.n_encoder_layers, 1, dev)
    return out
