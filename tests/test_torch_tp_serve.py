"""Tensor-parallel serving on the CPU, the paged pool and the options around
it, against the reference's tp=1 tokens.

The reference's own sharded paged path fails under this JAX
(``zero_pages`` at ``src/repro/kvcache/paged.py:80``, ROADMAP Queue C), so
the port's tp=2 is held against the reference's tp=1 here, its contract
("greedy tokens byte-identical to tp=1", ``src/repro/inference/
engine.py``): the paged pool in bf16 and int8, the tight pool with
preempt -> recompute and preempt -> host offload (each rank stages its
half of the pages, so the bytes halve against the port's tp=1), prefix
sharing with its copy-on-write, and speculative decoding on both caches;
then a fleet of two tensor-parallel replicas.  Reduced SmolLM (f32) with
its block weights scaled by 8, so greedy tokens depend on attention.
The port's ranks are processes of their own over gloo; a module fixture
serves every case at once, each engine in a thread of its own (a rank
takes seconds to start: it imports torch), and closes them all before
any test reads the results, so every test leaves no rank behind.
"""
import multiprocessing
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import init_params as jx_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.fleet import ReplicaFleet
from repro_torch.inference.router import RequestRouter
from repro_torch.workload import sample_requests

torch.set_num_threads(2)
COUNTERS = ("prefills", "decode_steps", "tokens_out", "prefill_chunks",
            "preemptions", "offload_transfers", "prefix_adoptions",
            "shared_prefix_tokens", "spec_rounds", "proposed", "accepted")
PAGED = dict(max_batch=2, max_len=32, cache="paged", block_size=4)
TIGHT = dict(max_batch=3, max_len=32, cache="paged", block_size=4,
             num_blocks=9, prefill_chunk=4)


@pytest.fixture(autouse=True)
def no_rank_left():
    yield
    left = multiprocessing.active_children()
    assert not left, f"rank processes left alive: {left}"


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf * 8 if str(getattr(path[-1], "key", "")) in (
            "wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate") else leaf,
        jx_init_params(jax.random.PRNGKey(0), jcfg))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _requests(cls, vocab, shared_prefix=False):
    """The reference test's four requests of 8 prompt tokens and 6 new;
    with ``shared_prefix`` the prompts share their first 8 tokens and the
    first request decodes longer, so its blocks are live when the others
    are admitted."""
    rng = np.random.default_rng(0)
    head = [int(t) for t in rng.integers(0, vocab, 8)]
    reqs = []
    for i in range(4):
        prompt = [int(t) for t in rng.integers(0, vocab, 8)]
        if shared_prefix:
            prompt = head + prompt[:1 + i]
        budget = 12 if shared_prefix and i == 0 else 6
        reqs.append(cls(i, prompt=prompt, max_new_tokens=budget))
    return reqs


def _tokens(done):
    return [list(r.generated) for r in sorted(done, key=lambda r: r.rid)]


CASES = {
    "paged_bf16": dict(PAGED),
    "paged_int8": dict(PAGED, kv_dtype="int8"),
    "preempt_recompute": dict(TIGHT),
    "preempt_offload": dict(TIGHT, offload="host"),
    "prefix_sharing": dict(PAGED, max_len=40, share_prefix=True),
    "speculative_contiguous": dict(max_batch=2, max_len=32,
                                   speculative=True, spec_k=3),
    "speculative_paged": dict(PAGED, speculative=True, spec_k=3),
}


def _serve(cfg, params, case):
    """One tp=2 engine of ``case`` from start to close: its tokens, stats
    and kind (run in a thread of its own, beside the others)."""
    kw = CASES[case]
    with ServeEngine(cfg, params, device="cpu", tp=2, **kw) as eng:
        done = eng.run(_requests(Request, cfg.vocab_size,
                                 kw.get("share_prefix", False)))
        return _tokens(done), eng.stats, eng.backend.info.kind


def _route(cfg, params, wl):
    with ReplicaFleet(cfg, params, replicas=2, tp=2, max_batch=2,
                      max_len=32, device="cpu", monitor=False) as fleet:
        ranks = len(multiprocessing.active_children())
        report = RequestRouter(fleet, policy="round-robin").route(
            _fleet_requests(wl.requests))
        return report, [rep.engine.stats.tp for rep in fleet.live()], ranks


def _fleet_requests(ws):
    return [Request(w.rid, prompt=list(w.prompt),
                    max_new_tokens=w.max_new_tokens, arrival_s=w.arrival_s)
            for w in ws]


@pytest.fixture(scope="module")
def served(setup):
    """Every case's tp=2 engine and the fleet, started together (each
    start spawns a rank and imports torch there), each closed before this
    returns; the reference's tp=1 engines run meanwhile."""
    jcfg, cfg, jparams, params = setup
    wl = sample_requests("agentic", 6, seed=3, vocab_size=cfg.vocab_size,
                         prompt_cap=12, output_cap=6, time_scale=50.0)
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {case: pool.submit(_serve, cfg, params, case)
                for case in CASES}
        fleet = pool.submit(_route, cfg, params, wl)
        want = {}
        for case, kw in CASES.items():
            jeng = JxServeEngine(jcfg, jparams, plan="jit",
                                 platform="Intel+H100", **kw)
            done = jeng.run(_requests(JxRequest, cfg.vocab_size,
                                      kw.get("share_prefix", False)))
            want[case] = (_tokens(done), jeng.stats)
        got = {case: f.result() for case, f in futs.items()}
        return got, want, (wl, fleet.result())


@pytest.mark.parametrize("case", list(CASES))
def test_tp2_serves_the_reference_tp1_tokens(setup, served, case):
    """Tokens and scheduling counters equal the reference engine's at
    tp=1; every call charged one dispatch a rank, the ranks' counts
    equal but for the draft's on rank 0.  Host offload stages half the
    bytes of the port's tp=1."""
    _, cfg, _, params = setup
    kw = CASES[case]
    (got, st, kind), (want, jst) = served[0][case], served[1][case]
    assert got == want
    for k in COUNTERS:
        assert getattr(st, k) == getattr(jst, k), k
    assert kind == ("speculative+sharded" if kw.get("speculative")
                    else "sharded")
    pd = st.per_device_dispatches
    # the draft's dispatches ride on rank 0's stream, as on the
    # reference's lead device
    assert set(pd) == {0, 1} and pd[0] - st.draft_dispatches == pd[1] > 0
    assert st.collectives > 0 and st.modeled_collective_tax_s > 0
    if not kw.get("speculative"):
        assert st.decode_dispatches == 2 * st.decode_steps
    if case.startswith("preempt"):
        assert st.preemptions > 0
    if case == "prefix_sharing":
        assert st.prefix_adoptions > 0
    if case == "preempt_offload":
        one = ServeEngine(cfg, params, device="cpu", **kw)
        assert _tokens(one.run(_requests(Request, cfg.vocab_size))) == want
        assert st.offload_bytes * 2 == one.stats.offload_bytes > 0
        assert st.restore_bytes * 2 == one.stats.restore_bytes > 0
        assert st.offload_bytes == st.restore_bytes


def test_a_fleet_of_tp2_replicas_serves_one_engines_tokens(setup, served):
    """Two replicas at tp=2, each on a rank process of its own, drain a
    workload round-robin; each replica's requests get the tokens one
    engine gives them alone."""
    _, cfg, _, params = setup
    wl, (report, tps, ranks) = served[2]
    assert tps == [2, 2] and ranks >= 2 and len(report.completed) == 6
    one = ServeEngine(cfg, params, max_batch=2, max_len=32, device="cpu",
                      monitor=False)
    for rep_rid in sorted(set(report.assignment.values())):
        part = [w for w in wl.requests
                if report.assignment[w.rid] == rep_rid]
        one.reset()
        for r in one.run(_fleet_requests(part)):
            assert report.tokens_by_rid[r.rid] == list(r.generated), r.rid
