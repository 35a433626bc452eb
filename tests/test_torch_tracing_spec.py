"""The port's request tracer on recompute preemption and speculative
engines, against the reference's (the rest of the tracing parity is in
``test_torch_tracing.py``).

The port's engine with a tracer on the paged pool under recompute
preemption, and a speculative engine (k = 2) on the contiguous cache and
on the paged pool, gives each request the JAX engine's sequence of event
kinds and their non-time fields: a speculative round is one decode
interval charged to each of its rows.  The segments of every request sum
to its end-to-end time.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import init_params as jx_init_params
from repro.telemetry.tracing import RequestTracer as JxTracer
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.telemetry import critical_path as cp
from repro_torch.telemetry.tracing import RequestTracer

torch.set_num_threads(2)
MAX_LEN = 32
META_KEYS = ("resume", "replay", "chunk", "batch", "mode", "n_tokens")
ENGINES = {
    "paged_recompute": dict(cache="paged", block_size=4, num_blocks=6),
    "speculative": dict(speculative=True, spec_k=2),
    "speculative_paged": dict(speculative=True, spec_k=2, cache="paged",
                              block_size=4),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _workload(cls, vocab):
    rng = np.random.default_rng(3)
    plens = [5, 12, 9, 3, 14]
    budgets = [6, 3, 8, 1, 5]
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(plens, budgets))]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_events_match_the_reference_engine(setup, name):
    jcfg, cfg, jparams, params = setup
    kw = ENGINES[name]
    jtracer, tracer = JxTracer(), RequestTracer()
    jreqs = _workload(JxRequest, cfg.vocab_size)
    JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN, plan="jit",
                  monitor=False, tracer=jtracer, **kw).run(jreqs)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      device="cpu", monitor=False, tracer=tracer, **kw)
    reqs = _workload(Request, cfg.vocab_size)
    eng.run(reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert sorted(tracer.traces) == sorted(jtracer.traces)
    for rid, jtr in jtracer.traces.items():
        ours = [(e.kind, tuple(e.meta.get(k) for k in META_KEYS))
                for e in tracer.traces[rid].events]
        assert ours == [(e.kind, tuple(e.meta.get(k) for k in META_KEYS))
                        for e in jtr.events], rid
    if name == "paged_recompute":
        assert any(e.kind == "prefill" and e.meta["replay"]
                   for tr in tracer.traces.values() for e in tr.events)
    else:
        # one decode interval a round, each row charged the whole round
        assert eng.stats.spec_rounds > 0
        n_decode = max(tr.count("decode") for tr in tracer.traces.values())
        assert 0 < n_decode <= eng.stats.spec_rounds
    a = cp.analyze(tracer)
    assert len(a.breakdowns) == len(reqs)
    for b in a.breakdowns:
        assert b.conserved, (b.rid, b.conservation_error)
        assert all(v >= 0 for v in b.segments.values())
