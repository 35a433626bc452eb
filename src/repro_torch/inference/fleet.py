"""Data-parallel replica fleet: N full ``ServeEngine``s as one tier.

Copy of ``repro/inference/fleet.py`` over the port's ``ServeEngine``.
Each replica is an unmodified engine over its own execution backend (its
own cache, CUDA graphs and registry), so everything the engine composes —
launch plans, paged KV with offload, speculative decoding — composes with
data parallelism: a fleet of R replicas at ``tp=T`` is the ``(data=R,
model=T)`` grid.  ``validate_mesh=True`` checks that the device pool holds
R*T GPUs and raises otherwise; without it the replicas time-multiplex the
one ``device`` and the fleet runs as a simulation of R devices (each
replica's clock advances by the measured wall time of its own calls, one
replica at a time) — the routing, queueing and accounting are the same
either way because the scheduler layer never touches placement.
A replica at ``tp > 1`` is an engine over a ``ShardedBackend``: its own
``tp`` rank processes (on one card, all of them share it).  ``close()``
stops every replica's ranks; a retired replica's stop as it is reaped.

The fleet owns replica lifecycle only (create, drain, retire, metrics
aggregation).  Request routing lives in ``repro_torch.inference.router``; the
fleet's job is to make "which replicas exist right now" a safe,
observable question while the router keeps dispatching.

Elastic resizing follows ``launch.elastic``: ``plan_fleet`` maps a device
pool (minus lost devices) to the largest ``(data, model)`` grid with the
model axis pinned to the serving ``tp``, and ``remove_replica`` drains
rather than kills — admitted requests finish on the draining replica,
un-admitted ones return to the caller for re-dispatch, so elasticity
never loses or corrupts an admitted request.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.inference.engine import EngineStats, Request, ServeEngine
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.telemetry.registry import MetricsRegistry

REPLICA_STATES = ("serving", "draining")


@dataclass
class Replica:
    """One fleet member: an engine plus its routing-visible state."""

    rid: int                        # fleet-wide replica id (never reused)
    engine: ServeEngine
    state: str = "serving"          # serving | draining
    requests: list = field(default_factory=list)   # every Request dispatched
    dispatched: int = 0             # lifetime dispatch count

    @property
    def serving(self) -> bool:
        """True while the router may dispatch new requests here."""
        return self.state == "serving"


class ReplicaFleet:
    """Replica lifecycle + fleet-level metrics for one model deployment.

    All replicas share one config and one params dict (data parallelism
    replicates weights; here every replica aliases the same device
    tensors: the backend keeps ``params`` as given, so no replica copies
    them), and each builds its own backend/cache through the normal
    ``ServeEngine`` constructor on ``device`` — ``engine_kwargs`` forwards
    serving options (plan, cache mode, tp, ...) to every replica
    identically.
    """

    def __init__(self, cfg, params, *, replicas: int, tp: int = 1,
                 registry: MetricsRegistry | None = None,
                 validate_mesh: bool = False, device="cuda",
                 **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        self.cfg = cfg
        self.params = params
        self.tp = tp
        self.engine_kwargs = dict(engine_kwargs)
        self.engine_kwargs["tp"] = tp
        self.device = device
        self.mesh = None
        if validate_mesh:
            # the real (data=R, model=T) grid: one GPU per (replica, shard)
            have = (torch.cuda.device_count()
                    if torch.cuda.is_available() else 0)
            if have < replicas * tp:
                raise ValueError(
                    f"fleet mesh (data={replicas}, model={tp}) needs "
                    f"{replicas * tp} GPUs, found {have}; drop "
                    "validate_mesh to time-multiplex the replicas on one "
                    "device")
            self.mesh = make_fleet_mesh(replicas, tp, device=device)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._g_replicas = self.registry.gauge(
            "fleet_replicas", "live replicas (serving + draining)")
        self._g_state = self.registry.gauge(
            "fleet_replica_state",
            "1 = serving (routable), 0 = draining", labels=("replica",))
        self._c_added = self.registry.counter(
            "fleet_replicas_added_total", "replicas added over the run")
        self._c_retired = self.registry.counter(
            "fleet_replicas_retired_total",
            "drained replicas detached from the fleet")
        self._next_rid = 0
        self.replicas: dict[int, Replica] = {}
        try:
            for _ in range(replicas):
                self.add_replica()
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ lifecycle
    def _make_engine(self) -> ServeEngine:
        """One fresh replica engine (own backend, cache, CUDA graphs,
        registry) on the fleet's device, over the shared weights."""
        return ServeEngine(self.cfg, self.params, device=self.device,
                           **self.engine_kwargs)

    def add_replica(self) -> Replica:
        """Attach a new serving replica (fresh engine, next fleet rid)."""
        rep = Replica(rid=self._next_rid, engine=self._make_engine())
        self._next_rid += 1
        self.replicas[rep.rid] = rep
        self._c_added.inc()
        self._note_states()
        return rep

    def remove_replica(self, rid: int) -> list[Request]:
        """Begin draining replica ``rid``; return its un-admitted requests.

        Admitted work (active slots, preempted-with-state) stays on the
        replica until it drains — re-homing it would discard KV or break
        the offload tier's ownership — so no admitted request is ever
        lost.  Queued-but-unadmitted requests are handed back for the
        router to re-dispatch.  The last serving replica cannot be
        removed (the fleet would deadlock with traffic still queued).
        """
        rep = self.replicas.get(rid)
        if rep is None or rep.state != "serving":
            raise ValueError(f"replica {rid} is not serving "
                             f"(live: {sorted(self.replicas)})")
        if len(self.serving()) <= 1:
            raise ValueError(
                "cannot remove the last serving replica; add_replica() "
                "first or drain traffic")
        rep.state = "draining"
        requeue = list(rep.engine._pending)
        rep.engine._pending.clear()
        for r in requeue:
            rep.requests.remove(r)
        rep.dispatched -= len(requeue)
        self._note_states()
        return requeue

    def reap(self) -> list[int]:
        """Retire every drained replica; return the retired rids."""
        retired = [rid for rid, rep in self.replicas.items()
                   if rep.state == "draining" and not rep.engine.busy]
        for rid in retired:
            self.replicas.pop(rid).engine.close()
            self._c_retired.inc()
        if retired:
            self._note_states()
        return retired

    def _note_states(self) -> None:
        """Refresh the replica-count and per-replica state gauges."""
        self._g_replicas.set(len(self.replicas))
        for rep in self.replicas.values():
            self._g_state.set(1.0 if rep.serving else 0.0,
                              replica=rep.rid)

    def close(self) -> None:
        """Release every live replica's backend (a tensor-parallel one
        stops its ranks)."""
        for rep in self.replicas.values():
            rep.engine.close()

    def __enter__(self) -> "ReplicaFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ views
    def serving(self) -> list[Replica]:
        """Replicas the router may dispatch to, in rid order."""
        return [self.replicas[r] for r in sorted(self.replicas)
                if self.replicas[r].serving]

    def live(self) -> list[Replica]:
        """Every attached replica (serving + draining), in rid order."""
        return [self.replicas[r] for r in sorted(self.replicas)]

    def busy(self) -> list[Replica]:
        """Live replicas that still hold work, in rid order."""
        return [rep for rep in self.live() if rep.engine.busy]

    # ------------------------------------------------------------ metrics
    def aggregate_metrics(self) -> MetricsRegistry:
        """Fleet-labeled registry view of every replica's EngineStats.

        Each ``engine_*`` scalar family becomes a ``fleet_engine_*``
        gauge with a ``replica`` label (one series per live replica), so
        one snapshot answers both "what did replica 2 do" and — summing
        the series — "what did the fleet do".  Router/fleet lifecycle
        families already live in ``self.registry`` and are merged in.
        """
        agg = MetricsRegistry()
        for attr, (name, _, help_text) in EngineStats._SCALARS.items():
            fam = agg.gauge(f"fleet_{name}", help_text,
                            labels=("replica",))
            for rep in self.live():
                fam.set(getattr(rep.engine.stats, attr), replica=rep.rid)
        g = agg.gauge("fleet_replica_queue_depth",
                      "requests pending+preempted+active per replica",
                      labels=("replica",))
        for rep in self.live():
            g.set(rep.engine.queue_depth, replica=rep.rid)
        g = agg.gauge("fleet_replica_clock_seconds",
                      "virtual serving clock per replica",
                      labels=("replica",))
        for rep in self.live():
            g.set(rep.engine.now, replica=rep.rid)
        # lifecycle + router families recorded live in self.registry
        snap = self.registry.snapshot()
        for name, fam in snap.items():
            if fam["type"] == "histogram":
                f = agg.histogram(name, fam["help"],
                                  labels=tuple(fam["label_names"]),
                                  buckets=tuple(fam["buckets"]))
                for s in fam["series"]:
                    v = s["value"]
                    f.merge_series(v["count"], v["sum"], v["buckets"],
                                   **s["labels"])
                continue
            dst = {"counter": agg.counter, "gauge": agg.gauge}.get(
                fam["type"])
            if dst is None:
                continue
            f = dst(name, fam["help"], labels=tuple(fam["label_names"]))
            for s in fam["series"]:
                if fam["type"] == "counter":
                    f.inc(s["value"], **s["labels"])
                else:
                    f.set(s["value"], **s["labels"])
        return agg

    def snapshot(self) -> dict:
        """Fleet snapshot: aggregated families + full per-replica dumps."""
        return {
            "fleet": self.aggregate_metrics().snapshot(),
            "replicas": {str(rep.rid): rep.engine.registry.snapshot()
                         for rep in self.live()},
        }
