"""Elastic scaling arithmetic: map a changed device pool to a new grid.

Copy of the pure arithmetic of ``repro/launch/elastic.py``:
``plan_reshape`` (the largest (data, model) grid that fits the surviving
pool) and ``plan_fleet`` (its serving variant with the model axis pinned
to the serving ``tp``), which the replica fleet's ``--remove-at`` /
``--add-at`` resizing follows.  The reference's ``elastic_restore``
(restore a checkpoint onto the current device pool) needs the checkpoint
manager and comes with ROADMAP Queue A, "training and launch tooling".
"""
from __future__ import annotations

from dataclasses import dataclass


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
