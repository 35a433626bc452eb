"""The port's request tracing and critical-path accounting against the
reference's.

* A hand-built timeline (router dispatch, clock skew, chunked prefill,
  batched decode, preemption with offload and restore tax, a rejection)
  through both tracers gives equal ``breakdown`` segments and pieces, SLO
  verdicts, ``slo_report``, ``triage`` and goodput families, and
  byte-identical ``request_trace`` JSON (host spans merged);
* the port's engine with a tracer, on the contiguous cache, the paged pool
  under preemption with host offload and chunked prefill, gives each
  request the JAX engine's sequence of event kinds and their non-time
  fields (times are each engine's own), and the segments of every request
  sum to its end-to-end time (recompute preemption and speculative
  engines: ``test_torch_tracing_spec.py``);
* a router-fed fleet stamps one dispatch per request and the queue-wait
  histogram aggregates; the tracer is kept by ``reset()``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core.export import request_trace as jx_request_trace
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import init_params as jx_init_params
from repro.telemetry import critical_path as jx_cp
from repro.telemetry.registry import MetricsRegistry as JxRegistry
from repro.telemetry.spans import SpanRecorder as JxSpanRecorder
from repro.telemetry.tracing import RequestTracer as JxTracer
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.export import (REQUEST_PID, request_trace,
                                     save_request_trace)
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.fleet import ReplicaFleet
from repro_torch.inference.router import RequestRouter
from repro_torch.telemetry import critical_path as cp
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.spans import SpanRecorder
from repro_torch.telemetry.tracing import RequestTracer
from repro_torch.workload import get_scenario

torch.set_num_threads(2)
MAX_LEN = 32
# the non-time meta fields each engine must agree on
META_KEYS = ("resume", "replay", "chunk", "batch", "mode", "n_tokens",
             "replica")


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _timeline(tr):
    """One fleet's worth of lifecycles, the same calls on either tracer."""
    # rid 0: routed, chunked prefill, two decode steps with rid 1
    tr.ingress(0, 0.0)
    tr.dispatch(0, 0.002, replica=1)
    tr.admit(0, 0.001)                     # replica clock behind the router
    tr.prefill(0, 0.003, 0.006, tax_s=0.0005, chunk=4)
    tr.prefill(0, 0.007, 0.009, tax_s=0.0004, chunk=2)
    tr.first_token(0, 0.009)
    tr.decode([0, 1], 0.010, 0.013, tax_s=0.001, batch=2,
              modeled_tklqt_s=0.002)
    # rid 1: engine-only, preempted with offload, restored, done
    tr.ingress(1, 0.0005)
    tr.admit(1, 0.004)
    tr.prefill(1, 0.004, 0.0065, tax_s=0.0002)
    tr.first_token(1, 0.0065)
    tr.preempt(1, 0.0135, mode="host", offload_bytes=4096,
               offload_tax_s=0.0007)
    tr.decode([0], 0.014, 0.0165, tax_s=0.0009, batch=1)
    tr.done(0, 0.0165, n_tokens=3)
    tr.admit(1, 0.020, resume=True, restore_bytes=4096,
             restore_tax_s=0.0006)
    tr.decode([1], 0.0205, 0.023, tax_s=0.0011, batch=1)
    tr.done(1, 0.023, n_tokens=4)
    # rid 2: a prefill cut by first_token inside it, and recompute replay
    tr.ingress(2, 0.001)
    tr.dispatch(2, 0.001, replica=0)
    tr.admit(2, 0.005)
    tr.prefill(2, 0.005, 0.008, tax_s=0.001)
    tr.first_token(2, 0.008)
    tr.preempt(2, 0.008, mode="recompute")
    tr.admit(2, 0.012, resume=True)
    tr.prefill(2, 0.012, 0.015, tax_s=0.0005, replay=True)
    tr.decode([2], 0.015, 0.019, tax_s=0.002, batch=1)
    tr.done(2, 0.019, n_tokens=2)
    # rid 3: rejected; rid 4: in flight (no done)
    tr.ingress(3, 0.002)
    tr.reject(3, 0.002)
    tr.ingress(4, 0.003)
    tr.admit(4, 0.021)
    return tr


def _spans(rec):
    rec.add("decode[b=2]", "decode", 0.010, 0.013, batch=2)
    rec.add("seg0", "dispatch", 0.010, 0.0105, tid=1)
    return rec.spans


def _analyses():
    return (jx_cp.analyze(_timeline(JxTracer())),
            cp.analyze(_timeline(RequestTracer())))


def test_breakdowns_match_the_reference():
    ja, a = _analyses()
    assert a.rejected == ja.rejected == [3]
    assert [b.rid for b in a.breakdowns] == [0, 1, 2]
    for jb, b in zip(ja.breakdowns, a.breakdowns):
        assert b.segments == jb.segments
        assert b.ttft_segments == jb.ttft_segments
        assert b.pieces == jb.pieces
        assert (b.replica, b.arrival_s, b.first_token_s, b.done_s,
                b.n_tokens, b.preemptions) == (
            jb.replica, jb.arrival_s, jb.first_token_s, jb.done_s,
            jb.n_tokens, jb.preemptions)
        assert (b.dominant, b.ttft_dominant) == (jb.dominant,
                                                 jb.ttft_dominant)
        assert b.conserved and b.conservation_error == jb.conservation_error
    assert a.aggregate() == ja.aggregate()
    assert a.tail_blame(50.0) == ja.tail_blame(50.0)
    # the carved taxes land where the reference puts them
    assert a.breakdowns[1].segments["offload_restore_tax"] > 0
    assert a.breakdowns[0].segments["router_queue_wait"] > 0


@pytest.mark.parametrize("slo", [(None, None), (0.005, None), (None, 0.002),
                                 (0.005, 0.002), (1.0, 1.0)])
def test_slo_report_triage_and_goodput_match_the_reference(slo):
    ja, a = _analyses()
    jslo, pslo = jx_cp.SLO(*slo), cp.SLO(*slo)
    assert [pslo.verdict(b) for b in a.breakdowns] == \
        [jslo.verdict(b) for b in ja.breakdowns]
    tri, jtri = cp.triage(a, pslo), jx_cp.triage(ja, jslo)
    assert json.dumps(tri, allow_nan=False) == json.dumps(jtri,
                                                          allow_nan=False)
    if "slo_report" in tri:
        reg, jreg = MetricsRegistry(), JxRegistry()
        cp.record_goodput(reg, tri["slo_report"])
        jx_cp.record_goodput(jreg, jtri["slo_report"])
        assert reg.to_prometheus() == jreg.to_prometheus()


def test_slo_resolution_matches_the_reference():
    from repro.workload import get_scenario as jx_get_scenario
    for name in ("chatbot", "code-completion"):
        for kw in ({}, {"ttft_ms": 100.0, "itl_ms": 0.0},
                   {"ttft_ms": 0.0}, {"itl_ms": 25.0}):
            s = cp.SLO.resolve(get_scenario(name), **kw)
            js = jx_cp.SLO.resolve(jx_get_scenario(name), **kw)
            assert (s.ttft_s, s.itl_s) == (js.ttft_s, js.itl_s)
    assert cp.SLO.resolve(None, 5.0, None) == cp.SLO(ttft_s=0.005)


def test_request_trace_json_is_the_reference_bytes(tmp_path):
    ja, a = _analyses()
    meta = {"scenario": "chatbot", "policy": "round-robin"}
    ours = request_trace(a, "Intel+H100", host_spans=_spans(SpanRecorder()),
                         metadata=meta)
    ref = jx_request_trace(ja, "Intel+H100",
                           host_spans=_spans(JxSpanRecorder()),
                           metadata=meta)
    assert json.dumps(ours, allow_nan=False) == json.dumps(ref,
                                                           allow_nan=False)
    path = save_request_trace(a, str(tmp_path / "t.json"),
                              platform="Intel+H100")
    with open(path) as fh:
        assert json.load(fh) == json.loads(json.dumps(
            jx_request_trace(ja, "Intel+H100")))


def _events(traces, rid):
    return [(e.kind, tuple(e.meta.get(k) for k in META_KEYS))
            for e in traces[rid].events]


def _workload(cls, vocab):
    rng = np.random.default_rng(3)
    plens = [5, 12, 9, 3, 14]
    budgets = [6, 3, 8, 1, 5]          # 1: done at prefill
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(plens, budgets))]


def _assert_conserved(analysis):
    assert analysis.breakdowns
    for b in analysis.breakdowns:
        assert b.conserved, (b.rid, b.conservation_error)
        assert all(v >= 0 for v in b.segments.values())
        assert b.pieces[0][1] == pytest.approx(b.arrival_s)
        assert b.pieces[-1][2] == pytest.approx(b.done_s)


ENGINES = {
    "contiguous": {},
    "paged_offload": dict(cache="paged", block_size=4, num_blocks=6,
                          offload="host"),
    "chunked": dict(cache="paged", block_size=4, prefill_chunk=4),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_events_match_the_reference_engine(setup, name):
    jcfg, cfg, jparams, params = setup
    kw = ENGINES[name]
    jtracer, tracer = JxTracer(), RequestTracer()
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit", monitor=False, tracer=jtracer, **kw)
    jreqs = _workload(JxRequest, cfg.vocab_size)
    jeng.run(jreqs)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      device="cpu", monitor=False, tracer=tracer, **kw)
    reqs = _workload(Request, cfg.vocab_size)
    eng.run(reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert sorted(tracer.traces) == sorted(jtracer.traces)
    for rid in jtracer.traces:
        assert _events(tracer.traces, rid) == _events(jtracer.traces, rid)
    kinds = {e.kind for tr in tracer.traces.values() for e in tr.events}
    if name == "paged_offload":
        assert "preempt" in kinds and eng.stats.restore_bytes > 0
    if name == "chunked":
        assert any(e.meta["chunk"] == 4 for tr in tracer.traces.values()
                   for e in tr.events if e.kind == "prefill")
    # a decode interval carries the measured launch tax of its call
    assert all(0.0 <= e.meta["tax_s"] <= e.dur + 1e-12
               for tr in tracer.traces.values() for e in tr.events
               if e.kind in ("prefill", "decode"))
    a = cp.analyze(tracer)
    assert len(a.breakdowns) == len(reqs)
    _assert_conserved(a)
    json.dumps(cp.triage(a, cp.SLO(ttft_s=1e-9)), allow_nan=False)


def test_rejections_and_reset_keep_the_tracer(setup):
    _, cfg, _, params = setup
    tracer = RequestTracer()
    eng = ServeEngine(cfg, params, max_batch=2, max_len=16, device="cpu",
                      monitor=False, tracer=tracer)
    reqs = [Request(0, prompt=[5] * 6, max_new_tokens=3),
            Request(1, prompt=[6] * 10, max_new_tokens=10)]   # 20 > 16
    eng.run(reqs)
    assert tracer.traces[1].first("reject") is not None
    a = cp.analyze(tracer)
    assert a.rejected == [1] and [b.rid for b in a.breakdowns] == [0]
    eng.reset()
    assert eng.tracer is tracer and len(tracer) == 2
    tracer.clear()
    eng.run([Request(2, prompt=[7] * 6, max_new_tokens=2)])
    assert list(tracer.traces) == [2]
    assert [e.kind for e in tracer.traces[2].events] == [
        "ingress", "admit", "prefill", "first_token", "decode", "done"]


def test_fleet_trace_dispatch_and_queue_wait(setup):
    _, cfg, _, params = setup
    tracer = RequestTracer()
    fleet = ReplicaFleet(cfg, params, replicas=2, max_batch=2,
                         max_len=MAX_LEN, device="cpu", monitor=False,
                         tracer=tracer)
    router = RequestRouter(fleet, tracer=tracer)
    n = 5
    report = router.route([Request(i, prompt=list(range(5, 11)),
                                   max_new_tokens=3, arrival_s=0.001 * i)
                           for i in range(n)])
    a = cp.analyze(tracer)
    assert len(a.breakdowns) == n
    _assert_conserved(a)
    for b in a.breakdowns:
        assert b.replica == report.assignment[b.rid]
        assert tracer.traces[b.rid].count("dispatch") == 1
        assert tracer.traces[b.rid].count("ingress") == 1
    assert {b.replica for b in a.breakdowns} == {0, 1}
    fam = fleet.registry.get("router_queue_wait_seconds")
    assert sum(fam.count(replica=r) for r in (0, 1)) == n
    hist = fleet.aggregate_metrics().snapshot()["router_queue_wait_seconds"]
    assert sum(s["value"]["count"] for s in hist["series"]) == n
    trace = json.loads(json.dumps(request_trace(a), allow_nan=False))
    evs = trace["traceEvents"]
    assert {e["tid"] for e in evs if e.get("pid") == REQUEST_PID
            and e["ph"] == "X"} == set(range(n))
    flows = {}
    for e in evs:
        if e.get("cat") == "request_flow":
            flows.setdefault(e["id"], []).append((e["ph"], e["pid"]))
    assert flows and all(sorted(v) == [("f", 0), ("s", REQUEST_PID)]
                         for v in flows.values())
