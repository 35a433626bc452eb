"""The serving tier on the card: the replica fleet, the router and the
request tracer around CUDA-graph engines.

Marked ``cuda``: each test skips without a GPU.  On a machine with one (and
without JAX, so without this directory's conftest):

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \\
        tests/test_torch_cuda_fleet.py

Reduced SmolLM-360M (2 layers, f32, TF32 off) with random weights: a
two-replica fleet under each policy serves every request the tokens a lone
engine gives it and launches the hand-written kernels, each replica from
CUDA graphs of its own that a ``reset()`` keeps; a traced engine on every
cache and under speculation conserves each request's latency; the route
CLI drains with a strict-JSON trace; the modeled tp sweep's traced step
holds the hand-written kernels.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.fleet import ReplicaFleet
from repro_torch.inference.router import RequestRouter
from repro_torch.launch import route
from repro_torch.models import init_params
from repro_torch.telemetry import critical_path as cp
from repro_torch.telemetry.characterize import tp_sweep
from repro_torch.telemetry.tracing import RequestTracer
from repro_torch.workload import sample_requests

pytestmark = pytest.mark.cuda
MAX_LEN = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(dev):
    cfg = reduced(get_config("smollm-360m"))
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)


def _workload(cfg, n=8, **kw):
    return sample_requests("chatbot", n, seed=3, vocab_size=cfg.vocab_size,
                           prompt_cap=12, output_cap=6, time_scale=100.0,
                           **kw)


@pytest.mark.parametrize("policy", ["round-robin", "least-queue-depth",
                                    "prefix-affinity"])
def test_fleet_tokens_equal_a_lone_engine(dev, policy):
    cfg, params = _model(dev)
    wl = _workload(cfg)
    fleet = ReplicaFleet(cfg, params, replicas=2, max_batch=2,
                         max_len=MAX_LEN, device=dev)
    for rep in fleet.live():                   # each warms its own graphs
        rep.engine.run(route.build_requests(wl))
        rep.engine.reset()
    captured = [rep.engine.backend.graph_stats.captured
                for rep in fleet.live()]
    assert all(captured)
    kernels.reset_launch_counts()
    report = RequestRouter(fleet, policy=policy).route(
        route.build_requests(wl))
    counts = kernels.launch_counts()
    assert len(report.completed) == wl.n
    assert counts["decode_attention"] > 0 and counts["flash_attention"] > 0
    # the warm-up captured every graph the drain replays
    assert [rep.engine.backend.graph_stats.captured
            for rep in fleet.live()] == captured
    lone = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device=dev)
    done = lone.run(route.build_requests(wl))
    assert report.tokens_by_rid == {r.rid: r.generated for r in done}


@pytest.mark.parametrize("kw", [
    {}, dict(cache="paged", block_size=4, num_blocks=6, offload="host"),
    dict(cache="paged", block_size=4, prefill_chunk=4),
    dict(speculative=True, spec_k=2)])
def test_traced_engine_conserves_on_the_card(dev, kw):
    cfg, params = _model(dev)
    tracer = RequestTracer()
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device=dev,
                      tracer=tracer, **kw)
    reqs = route.build_requests(_workload(cfg, 6))
    eng.run(reqs)
    eng.reset()
    tracer.clear()
    reqs = route.build_requests(_workload(cfg, 6))
    eng.run(reqs)
    a = cp.analyze(tracer)
    assert len(a.breakdowns) == len(reqs)
    assert all(b.conserved for b in a.breakdowns)
    for tr in tracer.traces.values():
        for e in tr.events:
            if e.kind in ("prefill", "decode"):
                assert 0.0 <= e.meta["tax_s"] <= e.dur + 1e-12
    if kw.get("offload"):
        assert eng.stats.preemptions > 0
        assert any(e.kind == "preempt" for tr in tracer.traces.values()
                   for e in tr.events)


def test_route_cli_drains_on_the_card(dev, tmp_path):
    trace = str(tmp_path / "route.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fleet, report, out = route.main([
            "--reduced", "--replicas", "2", "--requests", "8",
            "--max-len", str(MAX_LEN), "--trace-out", trace,
            "--cache", "paged", "--block-size", "4", "--remove-at", "3",
            "--add-at", "5"])
    assert out["requests_done"] == 8 and out["device"].startswith("cuda")
    assert out["triage"]["conservation"]["ok"]
    assert all(r["warmed"] == (rid != "2")
               for rid, r in out["per_replica"].items())
    with open(trace) as fh:
        json.load(fh, parse_constant=lambda c: pytest.fail(c))
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))


def test_tp_sweep_traces_the_hand_written_kernels(dev):
    cfg, params = _model(dev)
    sweep = tp_sweep(cfg, params, batches=(1, 4), tps=(1, 2),
                     platforms=("Intel+H100",), max_len=MAX_LEN, device=dev)
    assert len(sweep["points"]) == 4
    from repro_torch.telemetry.characterize import _decode_trace
    names = {k.name for k in _decode_trace(cfg, params, 4, MAX_LEN,
                                           dev).kernels}
    assert any("decode_attention" in n for n in names), sorted(names)
    np.testing.assert_array_less(0, [p["modeled_step_us"]
                                     for p in sweep["points"]])
