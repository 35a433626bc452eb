"""The port's replica fleet and router against the reference's.

Every case of ``tests/test_router.py`` on the port (the steppable engine,
byte-determinism against lone engines, streaming, the three policies,
least-queue-depth beating round-robin, elasticity, fleet metrics), plus
the reference itself on the same bridged weights: a drain's tokens by rid
equal the JAX fleet's and a lone port engine's, and the round-robin and
prefix-affinity assignments equal the JAX fleet's.  ``plan_fleet`` equals
the reference's.  Reduced SmolLM-360M in f32 on the CPU, where a request's
tokens do not depend on which replica or batch served it.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.inference.engine import Request as JxRequest
from repro.inference.fleet import ReplicaFleet as JxReplicaFleet
from repro.inference.router import RequestRouter as JxRequestRouter
from repro.launch.elastic import plan_fleet as jx_plan_fleet
from repro.launch.elastic import plan_reshape as jx_plan_reshape
from repro.models import init_params as jx_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.fleet import ReplicaFleet
from repro_torch.inference.router import (LeastQueueDepthPolicy,
                                          PrefixAffinityPolicy, RequestRouter,
                                          RoundRobinPolicy, TokenEvent,
                                          make_policy)
from repro_torch.launch.elastic import plan_fleet, plan_reshape
from repro_torch.workload import sample_requests

torch.set_num_threads(2)
MAX_LEN = 64


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    jcfg = jx_reduced(jx_get_config("smollm-360m"), n_layers=2)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return cfg, params, jcfg, jparams


def _requests(wl, cls=Request):
    return [cls(w.rid, prompt=list(w.prompt),
                max_new_tokens=w.max_new_tokens, arrival_s=w.arrival_s)
            for w in wl.requests]


def _fleet(tiny, n=2, **kw):
    cfg, params = tiny[:2]
    return ReplicaFleet(cfg, params, replicas=n, max_batch=2,
                        max_len=MAX_LEN, plan="jit", device="cpu",
                        monitor=False, **kw)


def _engine(tiny):
    cfg, params = tiny[:2]
    return ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, plan="jit",
                       device="cpu", monitor=False)


def _jx_route(tiny, wl, policy, actions=None, **kw):
    jcfg, jparams = tiny[2:]
    fleet = JxReplicaFleet(jcfg, jparams, replicas=2, max_batch=2,
                           max_len=MAX_LEN, plan="jit", monitor=False, **kw)
    return JxRequestRouter(fleet, policy=policy).route(
        _requests(wl, JxRequest), actions=actions)


class TestSteppableEngine:
    def test_run_equals_submit_tick(self, tiny):
        cfg = tiny[0]
        wl = sample_requests("chatbot", 5, seed=1, vocab_size=cfg.vocab_size,
                             prompt_cap=10, output_cap=5, time_scale=100.0)
        done1 = _engine(tiny).run(_requests(wl))
        e2 = _engine(tiny)
        reqs2 = _requests(wl)
        for r in reqs2:
            e2.submit(r)
        while e2.tick():
            pass
        assert {r.rid: r.generated for r in done1} == \
               {r.rid: r.generated for r in reqs2}
        assert all(r.done for r in reqs2)

    def test_queue_depth_and_outstanding(self, tiny):
        eng = _engine(tiny)
        assert eng.queue_depth == 0 and not eng.busy
        eng.submit(Request(0, prompt=[1, 2, 3], max_new_tokens=4))
        assert eng.busy and eng.queue_depth == 1
        assert eng.outstanding_tokens == 3 + 4
        eng.tick()                      # admitted + one decode step
        assert eng.outstanding_tokens == 4 - 2
        while eng.tick():
            pass
        assert eng.queue_depth == 0 and eng.outstanding_tokens == 0


class TestFleetByteDeterminism:
    def test_two_replica_drain_matches_single_engine_partitions(self, tiny):
        cfg = tiny[0]
        wl = sample_requests("agentic", 8, seed=3, vocab_size=cfg.vocab_size,
                             prompt_cap=12, output_cap=6, time_scale=50.0)
        fleet = _fleet(tiny)
        report = RequestRouter(fleet, policy="round-robin").route(
            _requests(wl))
        assert len(report.completed) == 8
        fleet_tokens = report.tokens_by_rid
        for rep_rid in sorted(set(report.assignment.values())):
            part = [w for w in wl.requests
                    if report.assignment[w.rid] == rep_rid]

            class _W:
                requests = part
            for r in _engine(tiny).run(_requests(_W)):
                assert fleet_tokens[r.rid] == list(r.generated), \
                    f"rid {r.rid} diverged on replica {rep_rid}"
        # the reference's fleet: the same assignment and tokens
        jrep = _jx_route(tiny, wl, "round-robin")
        assert report.assignment == jrep.assignment
        assert fleet_tokens == jrep.tokens_by_rid

    def test_streaming_covers_all_tokens_in_order(self, tiny):
        cfg = tiny[0]
        wl = sample_requests("chatbot", 5, seed=2, vocab_size=cfg.vocab_size,
                             prompt_cap=8, output_cap=4, time_scale=100.0)
        events = []
        report = RequestRouter(_fleet(tiny), on_token=events.append).route(
            _requests(wl))
        assert all(isinstance(ev, TokenEvent) for ev in events)
        streamed, last_t = {}, {}
        for ev in events:
            streamed.setdefault(ev.rid, []).append(ev.token)
            assert ev.index == len(streamed[ev.rid]) - 1
            assert ev.t >= last_t.get(ev.rid, 0.0)
            last_t[ev.rid] = ev.t
        assert streamed == report.tokens_by_rid
        assert report.token_events == sum(len(v) for v in streamed.values())


class TestPolicies:
    def _reps(self, tiny, n):
        return _fleet(tiny, n=n).serving()

    def test_round_robin_cycles(self, tiny):
        reps = self._reps(tiny, 3)
        pol = RoundRobinPolicy()
        req = Request(0, prompt=[1], max_new_tokens=1)
        assert [pol.choose(req, reps).rid for _ in range(6)] == \
            [0, 1, 2, 0, 1, 2]

    def test_least_queue_depth_picks_emptier(self, tiny):
        reps = self._reps(tiny, 2)
        reps[0].engine.submit(Request(0, prompt=[1, 2], max_new_tokens=2))
        assert LeastQueueDepthPolicy().choose(
            Request(1, prompt=[3], max_new_tokens=1), reps).rid == 1

    def test_least_queue_depth_token_tiebreak(self, tiny):
        reps = self._reps(tiny, 2)
        reps[0].engine.submit(Request(0, prompt=[1] * 8, max_new_tokens=16))
        reps[1].engine.submit(Request(1, prompt=[1], max_new_tokens=1))
        assert LeastQueueDepthPolicy().choose(
            Request(2, prompt=[2], max_new_tokens=1), reps).rid == 1

    def test_prefix_affinity_sticks_and_rehomes(self, tiny):
        reps = self._reps(tiny, 2)
        pol = PrefixAffinityPolicy(prefix_len=4)
        a = Request(0, prompt=[7, 7, 7, 7, 1], max_new_tokens=1)
        b = Request(1, prompt=[7, 7, 7, 7, 2], max_new_tokens=1)
        home = pol.choose(a, reps)
        assert pol.choose(b, reps).rid == home.rid
        other = [r for r in reps if r.rid != home.rid]
        assert pol.choose(b, other).rid != home.rid
        assert pol._home[(7, 7, 7, 7)] == other[0].rid

    def test_make_policy_rejects_unknown(self):
        with pytest.raises(ValueError, match="unknown routing policy"):
            make_policy("weighted-random")
        with pytest.raises(ValueError, match="prefix_len"):
            make_policy("prefix-affinity", prefix_len=0)

    def test_prefix_affinity_drain_matches_the_reference(self, tiny):
        """A shared system prompt on the paged pool with prefix sharing:
        the assignment, tokens and adoptions are the JAX fleet's."""
        cfg = tiny[0]
        wl = sample_requests("chatbot", 6, seed=4, vocab_size=cfg.vocab_size,
                             prompt_cap=8, output_cap=4, time_scale=100.0,
                             shared_prefix=8)
        kw = dict(cache="paged", block_size=4, share_prefix=True)
        fleet = _fleet(tiny, **kw)
        report = RequestRouter(fleet, policy="prefix-affinity").route(
            _requests(wl))
        jrep = _jx_route(tiny, wl, "prefix-affinity", **kw)
        assert report.assignment == jrep.assignment
        assert report.tokens_by_rid == jrep.tokens_by_rid
        assert sum(r.engine.stats.prefix_adoptions
                   for r in fleet.live()) > 0


class TestLeastQueueDepthBeatsRoundRobin:
    def test_skewed_lengths_measured_makespan(self, tiny):
        reqs = [Request(i, prompt=[(i % 50) + 2] * 4,
                        max_new_tokens=32 if i % 2 == 0 else 1)
                for i in range(8)]
        makespan = {}
        for policy in ("round-robin", "least-queue-depth"):
            fleet = _fleet(tiny)
            rep = RequestRouter(fleet, policy=policy).route(
                [Request(r.rid, prompt=list(r.prompt),
                         max_new_tokens=r.max_new_tokens) for r in reqs])
            assert len(rep.completed) == 8
            makespan[policy] = max(r.engine.stats.decode_steps
                                   for r in fleet.live())
        assert makespan["least-queue-depth"] < makespan["round-robin"], \
            f"measured makespans (decode steps): {makespan}"


class TestElasticity:
    def test_remove_then_add_mid_load_loses_nothing(self, tiny):
        cfg = tiny[0]
        wl = sample_requests("agentic", 10, seed=5, vocab_size=cfg.vocab_size,
                             prompt_cap=10, output_cap=5, time_scale=50.0)
        fleet = _fleet(tiny)
        reqs = _requests(wl)
        report = RequestRouter(fleet).route(reqs, actions=[
            (3, lambda rt: rt.remove_replica(0)),
            (6, lambda rt: rt.add_replica()),
        ])
        assert len(report.completed) == 10
        assert all(r.done for r in reqs)
        assert 0 not in fleet.replicas
        assert any(rep.rid >= 2 for rep in fleet.live())
        snap = fleet.registry.snapshot()
        assert snap["fleet_replicas_retired_total"]["series"][0]["value"] == 1
        assert snap["fleet_replicas_added_total"]["series"][0]["value"] == 3
        # the reference's fleet under the same resizing: the same tokens
        # (the assignment follows measured clocks, so it may differ)
        jrep = _jx_route(tiny, wl, "least-queue-depth", actions=[
            (3, lambda rt: rt.remove_replica(0)),
            (6, lambda rt: rt.add_replica())])
        assert report.tokens_by_rid == jrep.tokens_by_rid

    def test_requeued_results_still_byte_identical(self, tiny):
        cfg = tiny[0]
        wl = sample_requests("chatbot", 6, seed=7, vocab_size=cfg.vocab_size,
                             prompt_cap=8, output_cap=4, time_scale=50.0)
        fleet = _fleet(tiny)
        report = RequestRouter(fleet).route(
            _requests(wl), actions=[(2, lambda rt: rt.remove_replica(0))])
        assert len(report.completed) == 6
        for w in wl.requests:
            done = _engine(tiny).run([Request(w.rid, prompt=list(w.prompt),
                                              max_new_tokens=w.max_new_tokens)])
            assert report.tokens_by_rid[w.rid] == list(done[0].generated)

    def test_cannot_remove_last_serving_replica(self, tiny):
        fleet = _fleet(tiny)
        fleet.remove_replica(0)
        with pytest.raises(ValueError, match="last serving replica"):
            fleet.remove_replica(1)

    def test_plan_fleet_pins_model_axis(self):
        for n, tp, lost in ((8, 2, 0), (8, 2, 3), (6, 1, 1), (4, 4, 0),
                            (16, 8, 1)):
            ours, ref = plan_fleet(n, tp, lost), jx_plan_fleet(n, tp, lost)
            assert (ours.old_devices, ours.new_devices, ours.mesh_shape) == \
                (ref.old_devices, ref.new_devices, ref.mesh_shape)
        for n, lost in ((8, 0), (7, 0), (12, 2), (1, 0)):
            assert plan_reshape(n, lost).mesh_shape == \
                jx_plan_reshape(n, lost).mesh_shape
        assert plan_fleet(8, tp=2, lost=3).mesh_shape == (2, 2)
        with pytest.raises(ValueError, match="cannot hold"):
            plan_fleet(4, tp=4, lost=1)
        with pytest.raises(ValueError, match="tp must be"):
            plan_fleet(4, tp=0)


class TestFleetMetrics:
    def test_aggregation_has_per_replica_labels(self, tiny):
        cfg = tiny[0]
        wl = sample_requests("chatbot", 4, seed=1, vocab_size=cfg.vocab_size,
                             prompt_cap=8, output_cap=3, time_scale=100.0)
        fleet = _fleet(tiny)
        RequestRouter(fleet, policy="round-robin").route(_requests(wl))
        snap = fleet.snapshot()
        agg = snap["fleet"]
        for fam in ("fleet_engine_tokens_out", "fleet_replica_queue_depth",
                    "fleet_replica_clock_seconds", "fleet_replicas",
                    "router_dispatches_total", "router_completed_total",
                    "router_token_events_total", "router_queue_depth",
                    "router_queue_wait_seconds"):
            assert fam in agg, f"missing family {fam}"
        tok = {s["labels"]["replica"]: s["value"]
               for s in agg["fleet_engine_tokens_out"]["series"]}
        assert set(tok) == {"0", "1"} and all(v > 0 for v in tok.values())
        assert agg["router_completed_total"]["series"][0]["value"] == 4
        disp = {s["labels"]["replica"]: s["value"]
                for s in agg["router_dispatches_total"]["series"]}
        assert sum(disp.values()) == 4
        assert sum(s["value"]["count"] for s in
                   agg["router_queue_wait_seconds"]["series"]) == 4
        assert set(snap["replicas"]) == {"0", "1"}
        assert "engine_tokens_out" in snap["replicas"]["0"]
        # the fleet registry exports as Prometheus text
        assert "router_queue_wait_seconds_count" in \
            fleet.aggregate_metrics().to_prometheus()

    def test_route_with_no_serving_replica_raises(self, tiny):
        fleet = _fleet(tiny)
        fleet.remove_replica(0)
        fleet.replicas[1].state = "draining"
        with pytest.raises(RuntimeError, match="no serving replica"):
            RequestRouter(fleet).route(
                [Request(0, prompt=[1, 2], max_new_tokens=1)])

    def test_replicas_share_the_weight_tensors(self, tiny):
        fleet = _fleet(tiny, n=3)
        embeds = {rep.engine.backend.params["embed"].data_ptr()
                  for rep in fleet.live()}
        assert embeds == {tiny[1]["embed"].data_ptr()}

    def test_mesh_validation_and_tensor_parallel_refusal(self, tiny):
        """``validate_mesh`` asks for replicas x tp GPUs before any rank
        starts; without it a fleet of tensor-parallel replicas builds,
        each replica on ranks of its own, and ``close`` stops them."""
        import multiprocessing
        cfg, params = tiny[:2]
        if not torch.cuda.is_available():
            with pytest.raises(ValueError, match="needs 2 GPUs, found 0"):
                _fleet(tiny, validate_mesh=True)
            with pytest.raises(ValueError, match="needs 4 GPUs, found 0"):
                _fleet(tiny, tp=2, validate_mesh=True)
        with ReplicaFleet(cfg, params, replicas=2, tp=2,
                          device="cpu") as fleet:
            assert [rep.engine.backend.info.kind
                    for rep in fleet.live()] == ["sharded", "sharded"]
            assert len(multiprocessing.active_children()) == 2
        assert not multiprocessing.active_children()
