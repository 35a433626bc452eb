"""Elastic scaling controller: reshard a run across device-count changes.

Counterpart of ``repro/launch/elastic.py``: ``plan_reshape`` (the largest
(data, model) grid that fits the surviving pool), ``plan_fleet`` (its
serving variant with the model axis pinned to the serving ``tp``, which
the replica fleet's ``--remove-at`` / ``--add-at`` resizing follows) and
``elastic_restore``.  The checkpoint stores whole leaves
(``checkpoint.CheckpointManager``), so restoring onto a different mesh is
restoring and cutting each rank's shard by the current mesh's specs: a
checkpoint written at one mesh restores at any other.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (param_specs, shard_for_rank,
                                              shardings_for)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tree import map_tree


@dataclass
class ElasticPlan:
    old_devices: int
    new_devices: int
    mesh_shape: tuple


def plan_reshape(n_devices: int, lost: int = 0) -> ElasticPlan:
    """Largest (data, model) grid that fits the surviving device pool.
    Prefers shrinking the data axis — model-sharded weights keep layout."""
    avail = n_devices - lost
    model = 1
    for m in (16, 8, 4, 2, 1):
        if avail % m == 0 and m <= avail:
            model = m
            break
    return ElasticPlan(n_devices, avail, (avail // model, model))


def plan_fleet(n_devices: int, tp: int, lost: int = 0) -> ElasticPlan:
    """Serving-fleet variant of ``plan_reshape``: model axis pinned.

    A serving fleet cannot reshard tensor-parallel weights on the fly
    the way training restores can, so the model axis stays at the
    serving ``tp`` and only the data axis (replica count) tracks the
    surviving device pool: ``replicas = (n_devices - lost) // tp``.
    The router then drains surplus replicas (``ReplicaFleet.
    remove_replica``) or attaches new ones — byte-deterministic because
    admitted requests never move between replicas.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    avail = n_devices - lost
    if avail < tp:
        raise ValueError(
            f"{avail} surviving devices cannot hold even one tp={tp} "
            f"replica (need >= {tp})")
    return ElasticPlan(n_devices, avail, (avail // tp, tp))


def elastic_restore(ckpt, step: int, target_tree, cfg: ModelConfig,
                    mesh=None, device="cuda"):
    """Restore checkpoint ``step`` onto the current device pool.  Returns
    (shards, mesh): ``shards[r]`` is rank r's tree, each leaf its slice by
    ``param_specs`` over ``mesh`` on the rank's device.  With ``mesh=None``
    the mesh is ``plan_reshape`` of the visible CUDA devices (of
    ``device``; one rank on the CPU), as the reference's over its
    devices."""
    if mesh is None:
        dev = resolve_device(device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        data, model = plan_reshape(n).mesh_shape
        mesh = make_host_mesh(data=data, model=model, device=dev)
    full = ckpt.restore(step, target_tree)
    specs = shardings_for(full, param_specs(full, cfg, mesh), mesh)
    return [map_tree(lambda t, d=d: t.to(d),
                     shard_for_rank(full, specs, mesh, r))
            for r, d in enumerate(mesh.devices)], mesh
