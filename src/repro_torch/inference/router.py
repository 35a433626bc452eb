"""Async request router: one ingress queue over a replica fleet.

Copy of ``repro/inference/router.py`` over the port's ``ReplicaFleet``.

The router is the fleet's frontend: workload-generated requests enter a
central admission queue, a pluggable policy picks a serving replica for
each, and per-token output streams back through ``on_token`` as replicas
emit.  Execution is a deterministic discrete-event loop over the fleet's
virtual clocks ("async" in the event-driven sense — cooperative progress
over many replicas, no wall-clock sleeps, no thread nondeterminism):
each round the router releases arrivals that are due, dispatches the
queue, then ticks the busy replica whose clock lags furthest behind, so
replica timelines advance in lock-step exactly as a real async frontend
would interleave them.

Because each replica is an unmodified ``ServeEngine`` and greedy tokens
are batch-composition-independent (exactly so in f32 on the CPU; in bf16
on the GPU a matmul may pick another kernel for another row count, so two
batch compositions can part at a near tie), every request's output is
the one a lone engine gives the same request — the router changes who
serves and when, never what is served.

Routing policies (``make_policy``):

  round-robin        cycle over serving replicas in rid order
  least-queue-depth  fewest queued+active requests; outstanding-token
                     tie-break (two equal-depth replicas can hold very
                     different amounts of work)
  prefix-affinity    requests sharing a prompt prefix stick to the
                     replica that saw the prefix first (KV/prefix-cache
                     locality); unseen prefixes fall back to
                     least-queue-depth
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.inference.engine import Request
from repro_torch.inference.fleet import Replica, ReplicaFleet

POLICIES = ("round-robin", "least-queue-depth", "prefix-affinity")


def _least_loaded(replicas: list[Replica]) -> Replica:
    """Lowest (queue depth, outstanding tokens, rid) serving replica."""
    return min(replicas, key=lambda rep: (rep.engine.queue_depth,
                                          rep.engine.outstanding_tokens,
                                          rep.rid))


class RoundRobinPolicy:
    """Cycle over serving replicas in rid order, load-blind."""

    name = "round-robin"

    def __init__(self):
        self._turn = 0

    def choose(self, req: Request, replicas: list[Replica]) -> Replica:
        """Next replica in the cycle (rid order, wrapping)."""
        rep = replicas[self._turn % len(replicas)]
        self._turn += 1
        return rep


class LeastQueueDepthPolicy:
    """Route to the replica with the fewest outstanding requests.

    Queue depth counts pending + preempted + active requests on the
    replica's engine; ties break on outstanding tokens (remaining prompt
    + decode budget), then rid — so a burst of equal-depth replicas
    still balances by actual work, not arrival parity.
    """

    name = "least-queue-depth"

    def choose(self, req: Request, replicas: list[Replica]) -> Replica:
        """The least-loaded serving replica right now."""
        return _least_loaded(replicas)


class PrefixAffinityPolicy:
    """Sticky routing by prompt prefix (cache-locality routing).

    Requests whose first ``prefix_len`` prompt tokens match are sent to
    the replica that first served that prefix — the replica whose KV
    pages / prefix cache already hold the shared context.  Unseen
    prefixes, and prefixes whose home replica has drained away, fall
    back to least-queue-depth and re-home the prefix there.
    """

    name = "prefix-affinity"

    def __init__(self, prefix_len: int = 8):
        if prefix_len < 1:
            raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
        self.prefix_len = prefix_len
        self._home: dict[tuple, int] = {}

    def choose(self, req: Request, replicas: list[Replica]) -> Replica:
        """The prefix's home replica, (re)assigned least-loaded-first."""
        key = tuple(req.prompt[:self.prefix_len])
        by_rid = {rep.rid: rep for rep in replicas}
        home = self._home.get(key)
        if home in by_rid:
            return by_rid[home]
        rep = _least_loaded(replicas)
        self._home[key] = rep.rid
        return rep


def make_policy(name: str, **kwargs):
    """Policy instance for a ``POLICIES`` name (kwargs reach __init__)."""
    table = {"round-robin": RoundRobinPolicy,
             "least-queue-depth": LeastQueueDepthPolicy,
             "prefix-affinity": PrefixAffinityPolicy}
    try:
        return table[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown routing policy {name!r}; "
                         f"expected one of {POLICIES}") from None


@dataclass
class TokenEvent:
    """One streamed token: which request emitted what, where and when."""

    rid: int                        # request id
    replica: int                    # fleet replica rid that emitted it
    index: int                      # position in the request's output
    token: int                      # token id
    t: float                        # emitting replica's virtual clock


@dataclass
class RouterReport:
    """Outcome of one ``RequestRouter.route()`` drain."""

    policy: str
    clock_s: float                  # router clock at drain (makespan)
    completed: list = field(default_factory=list)    # done Requests
    assignment: dict = field(default_factory=dict)   # rid -> replica rid
    token_events: int = 0
    dispatches: int = 0
    requeued: int = 0               # re-dispatched off draining replicas

    @property
    def tokens_by_rid(self) -> dict:
        """Generated token list per request id."""
        return {r.rid: list(r.generated) for r in self.completed}


class RequestRouter:
    """Central admission queue + routing policy over a ``ReplicaFleet``.

    ``route(requests)`` runs the discrete-event loop to drain: release
    due arrivals into the queue, dispatch by policy, tick the
    furthest-behind busy replica, stream newly emitted tokens, retire
    drained replicas.  ``remove_replica``/``add_replica`` may be called
    mid-route (directly or via ``actions``) — dispatch simply stops
    targeting draining replicas and their un-admitted requests re-enter
    the queue at their original arrival order.
    """

    def __init__(self, fleet: ReplicaFleet, policy="least-queue-depth",
                 on_token=None, tracer=None):
        self.fleet = fleet
        self.policy = (make_policy(policy) if isinstance(policy, str)
                       else policy)
        self.on_token = on_token        # callable(TokenEvent) or None
        # request-scoped lifecycle tracer; pass the SAME instance to the
        # fleet (engine_kwargs tracer=) so traces span router + replicas
        self.tracer = tracer
        self.clock = 0.0                # router virtual time (monotonic)
        reg = fleet.registry
        self._g_queue = reg.gauge(
            "router_queue_depth",
            "requests in the central admission queue")
        self._g_clock = reg.gauge(
            "router_clock_seconds", "router virtual clock")
        self._c_dispatch = reg.counter(
            "router_dispatches_total",
            "routing decisions by target replica",
            labels=("replica", "policy"))
        self._c_requeued = reg.counter(
            "router_requeued_total",
            "requests re-dispatched off a draining replica")
        self._c_tokens = reg.counter(
            "router_token_events_total", "tokens streamed through on_token")
        self._c_completed = reg.counter(
            "router_completed_total", "requests finished fleet-wide")
        self._h_queue_wait = reg.histogram(
            "router_queue_wait_seconds",
            "per-request ingress-queue wait: arrival to policy dispatch",
            labels=("replica",))
        self._queue: deque = deque()
        self._emitted: dict[int, int] = {}   # rid -> tokens streamed
        self._watch: dict[int, Replica] = {}  # rid -> emitting replica
        self._report: RouterReport | None = None

    # ------------------------------------------------------------ elasticity
    def add_replica(self) -> int:
        """Attach a fresh serving replica mid-route; returns its rid."""
        return self.fleet.add_replica().rid

    def remove_replica(self, rid: int) -> int:
        """Drain replica ``rid``; its queued requests re-enter the
        router queue (original arrival order).  Returns how many were
        requeued."""
        requeue = self.fleet.remove_replica(rid)
        for req in requeue:
            self._watch.pop(req.rid, None)
        if requeue:
            merged = sorted(list(self._queue) + requeue,
                            key=lambda r: r.arrival_s)
            self._queue = deque(merged)
            self._c_requeued.inc(len(requeue))
            if self._report is not None:
                self._report.requeued += len(requeue)
        return len(requeue)

    # ------------------------------------------------------------ internals
    def _dispatch(self, req: Request) -> Replica:
        """Policy-route one request and submit it to the chosen engine."""
        serving = self.fleet.serving()
        if not serving:
            raise RuntimeError(
                "router has queued traffic but no serving replica; "
                "add_replica() before draining the fleet")
        rep = self.policy.choose(req, serving)
        if self.tracer is not None:
            self.tracer.dispatch(req.rid, self.clock, replica=rep.rid)
        rep.engine.submit(req)
        rep.requests.append(req)
        rep.dispatched += 1
        self._watch[req.rid] = rep
        self._c_dispatch.inc(replica=rep.rid, policy=self.policy.name)
        self._h_queue_wait.observe(max(0.0, self.clock - req.arrival_s),
                                   replica=rep.rid)
        if self._report is not None:
            self._report.assignment[req.rid] = rep.rid
            self._report.dispatches += 1
        return rep

    def _stream(self, rep: Replica) -> None:
        """Emit TokenEvents for tokens ``rep`` produced since last seen."""
        for req in rep.requests:
            seen = self._emitted.get(req.rid, 0)
            n = len(req.generated)
            if n > seen:
                for j in range(seen, n):
                    ev = TokenEvent(rid=req.rid, replica=rep.rid,
                                    index=j, token=int(req.generated[j]),
                                    t=rep.engine.now)
                    if self.on_token is not None:
                        self.on_token(ev)
                self._c_tokens.inc(n - seen)
                self._emitted[req.rid] = n
            if req.done and self._watch.pop(req.rid, None) is not None:
                self._c_completed.inc()
                if self._report is not None:
                    self._report.completed.append(req)

    def _frontier(self) -> float:
        """Lagging edge of fleet progress: min busy-replica clock."""
        busy = self.fleet.busy()
        return min((rep.engine.now for rep in busy),
                   default=self.clock) if busy else self.clock

    # ------------------------------------------------------------ main loop
    def route(self, requests: list[Request], *, actions=None) -> RouterReport:
        """Drain ``requests`` through the fleet; returns a RouterReport.

        ``actions`` is an optional list of ``(dispatch_count, fn)``
        pairs: after the Nth dispatch, ``fn(self)`` runs once — the
        deterministic hook the elastic tests and the CLI's
        ``--remove-at/--add-at`` use to resize the fleet under load.
        """
        arrivals = sorted(requests, key=lambda r: r.arrival_s)
        pending_actions = sorted(actions or [], key=lambda a: a[0])
        self._report = report = RouterReport(policy=self.policy.name,
                                             clock_s=0.0)
        i = 0
        while True:
            self.fleet.reap()
            self.clock = max(self.clock, self._frontier())
            while i < len(arrivals) and \
                    arrivals[i].arrival_s <= self.clock:
                if self.tracer is not None:
                    self.tracer.ingress(arrivals[i].rid,
                                        arrivals[i].arrival_s)
                self._queue.append(arrivals[i])
                i += 1
            busy = self.fleet.busy()
            if not busy and not self._queue:
                if i >= len(arrivals):
                    break               # drained
                # idle fast-forward: jump the router clock to the next
                # arrival instead of spinning (mirrors the engine clock)
                self.clock = arrivals[i].arrival_s
                continue
            while self._queue:
                self._dispatch(self._queue.popleft())
                while pending_actions and \
                        report.dispatches >= pending_actions[0][0]:
                    pending_actions.pop(0)[1](self)
            # tick the busy replica whose virtual clock lags furthest:
            # replica timelines advance in lock-step, so arrivals are
            # released against a consistent global time
            busy = self.fleet.busy()
            if busy:
                rep = min(busy, key=lambda r: (r.engine.now, r.rid))
                rep.engine.tick()
                self._stream(rep)
            self._g_queue.set(len(self._queue))
            self._g_clock.set(self.clock)
        self.fleet.reap()
        self._g_queue.set(0)
        self._g_clock.set(self.clock)
        report.clock_s = self.clock
        report.token_events = int(sum(
            s["value"] for s in
            self.fleet.registry.snapshot()
            ["router_token_events_total"]["series"]))
        self._report = None
        return report
