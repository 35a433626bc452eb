"""Mesh construction for the serving backends.

Counterpart of ``repro/launch/mesh.py`` (``make_host_mesh``,
``make_fleet_mesh``, ``dp_axes_of``, ``tp_axis_of``), with the same
``must be >= 1`` errors.  In the port a mesh is the rank grid and each
rank's device; the process group over it is made by the backend that
starts the ranks (``inference.backends.sharded``).  Ranks go round-robin
over the CUDA devices present: with fewer GPUs than ranks, ranks share a
card, and ``Mesh.devices`` says so (two ranks on one H100: ``(cuda:0,
cuda:0)``).  On the CPU every rank runs on the CPU.  So no device count
is required; ``ReplicaFleet(validate_mesh=True)`` asks for one GPU per
rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, axis name -> size) and the device of every
    rank, rank-major over the axes in order."""
    shape: dict
    devices: tuple

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def rank_devices(n: int, device="cuda") -> tuple:
    """The device of each of ``n`` ranks: round-robin over the visible
    CUDA devices (ranks beyond the count share cards), or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (dev,) * n
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", (dev.index + r) % count)
                 for r in range(n))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device="cuda") -> Mesh:
    """Small mesh over whatever devices exist (tests / local runs)."""
    for name, size in (("data", data), ("model", model)):
        if size < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {size}")
    if pod < 0:
        raise ValueError(f"mesh axis 'pod' must be >= 0, got {pod}")
    shape = {"pod": pod, "data": data, "model": model} if pod else {
        "data": data, "model": model}
    return Mesh(shape, rank_devices(math.prod(shape.values()), device))


def make_fleet_mesh(replicas: int, tp: int = 1, device="cuda") -> Mesh:
    """``(data=replicas, model=tp)`` grid for a serving replica fleet: the
    data axis indexes replicas, the model axis each replica's
    tensor-parallel ranks."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    return make_host_mesh(data=replicas, model=tp, device=device)


def dp_axes_of(mesh) -> tuple:
    """Mesh axis names that carry data parallelism."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis_of(mesh) -> str:
    """Mesh axis name that carries tensor parallelism."""
    return "model"
