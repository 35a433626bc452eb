"""Serving tier: scheduler (`engine`), execution backends, replica fleet
(`fleet`/`router`), and the KV quantization math (`kv_quant`).

`kv_quant` is imported eagerly (it only needs torch); the heavyweight
serving classes are re-exported lazily (through `importlib`) so
`import repro_torch.inference` stays cheap and cycle-free for the layers
that consume the quant helpers.
"""
from __future__ import annotations

import importlib

from repro_torch.inference import kv_quant
from repro_torch.inference.kv_quant import (
    KV_DTYPES,
    capacity_ratio,
    dequantize_kv,
    kv_entry_bytes,
    quantize_kv,
)

__all__ = [
    "KV_DTYPES",
    "capacity_ratio",
    "dequantize_kv",
    "kv_entry_bytes",
    "kv_quant",
    "quantize_kv",
    "Request",
    "ServeEngine",
    "ReplicaFleet",
    "RequestRouter",
]

_LAZY = {
    "Request": ("repro_torch.inference.engine", "Request"),
    "ServeEngine": ("repro_torch.inference.engine", "ServeEngine"),
    "ReplicaFleet": ("repro_torch.inference.fleet", "ReplicaFleet"),
    "RequestRouter": ("repro_torch.inference.router", "RequestRouter"),
}


def __getattr__(name: str):
    """Lazy re-export of the serving surface (PEP 562)."""
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod_name), attr)
