"""The port's serving engine against the reference's, on reduced SmolLM.

Six requests of ragged prompt lengths and budgets through ``max_batch 2``
(so slots are reused): greedy tokens byte-identical to the JAX
``ServeEngine(plan="jit")`` on the same bridged weights, with the same
scheduling counters, also under ``plan="autotuned"`` and with the live
monitor, and at tp=2.  Also: without ``device=`` the engine asks for the
GPU and raises where there is none, and the options the reference refuses
raise (the paged cache's parity is in ``test_torch_paged_serve.py``; tensor
parallelism's in ``test_torch_tp.py`` and ``test_torch_tp_serve.py``).
"""
import contextlib
import io
import json

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
from repro_torch.launch import serve

torch.set_num_threads(2)
MAX_LEN = 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _workload(cls, vocab):
    rng = np.random.default_rng(7)
    plens = [5, 12, 9, 3, 16, 7]
    budgets = [6, 3, 8, 1, 5, 30]     # 1: done at prefill; 30: rejected
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(plens, budgets))]


def test_greedy_tokens_match_the_reference_engine(setup):
    jcfg, cfg, jparams, params = setup
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit")
    jreqs = _workload(JxRequest, cfg.vocab_size)
    jeng.run(jreqs)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      device="cpu")
    reqs = _workload(Request, cfg.vocab_size)
    eng.run(reqs)
    for jr, r in zip(jreqs, reqs):
        assert r.status == jr.status
        assert r.generated == jr.generated, r.rid
    assert [r.status for r in reqs].count("rejected") == 1
    js, st = jeng.stats, eng.stats
    for field in ("prefills", "decode_steps", "tokens_out", "rejected"):
        assert getattr(st, field) == getattr(js, field), field
    assert st.slot_occupancy == js.slot_occupancy
    assert set(st.ttft_s) == set(js.ttft_s)
    assert st.plan == "jit" and eng.backend.info.tp == 1
    snap = eng.registry.snapshot()      # EngineStats is a registry view
    assert snap["engine_tokens_out"]["series"][0]["value"] == st.tokens_out
    # reset keeps the engine; the same workload gives the same tokens
    eng.reset()
    again = _workload(Request, cfg.vocab_size)
    eng.run(again)
    assert [r.generated for r in again] == [r.generated for r in reqs]
    assert eng.stats.prefills == js.prefills


def test_engine_defaults_to_the_gpu(setup):
    _, cfg, _, params = setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)


@pytest.mark.parametrize("kw", [
    dict(speculative=True, plan="eager"),
    dict(cache="paged", tp=2),
    dict(speculative=True, greedy=False),
    dict(tp=2), dict(cache="paged", kv_dtype="int8", tp=4)])
def test_unported_options_raise(setup, kw):
    """Speculation outside ``plan="jit"`` or without greedy decoding raises
    as the reference's engine does.  Tensor parallelism is ported: tp=2 on
    either cache serves the JAX engine's tokens, and tp=4, which does not
    divide reduced SmolLM's 2 KV heads, raises the reference's
    divisibility error before any rank starts.  The request tracer is
    ported (``test_torch_tracing.py``)."""
    jcfg, cfg, jparams, params = setup
    if kw.get("tp") == 2:
        jkw = {k: v for k, v in kw.items() if k != "tp"}
        jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                             plan="jit", platform="Intel+H100", **jkw)
        want = [r.generated for r in jeng.run(_workload(JxRequest,
                                                        cfg.vocab_size))]
        with ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                         device="cpu", **kw) as eng:
            got = [r.generated for r in eng.run(_workload(Request,
                                                          cfg.vocab_size))]
            assert eng.backend.info.kind == "sharded"
            assert eng.stats.collectives > 0
        assert got == want
        return
    match = ("plan='jit'" if kw.get("plan") == "eager"
             else "greedy" if "greedy" in kw
             else "must divide n_kv_heads")
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                    **kw)


@pytest.mark.parametrize("kw", [
    dict(plan="autotuned", plan_table={
        "version": 1, "arch": "smollm-360m", "platform": "Intel+H100",
        "entries": {"1": {"batch": 1, "region": "CPU-bound",
                          "selected": "chain"}}}),
    dict(monitor=True), dict(plan_table={})])
def test_ported_options_serve_the_reference_tokens(setup, kw):
    """The options ported with the measured characterization (a plan
    table, the live monitor, a table beside a named plan, which the
    reference ignores) serve the JAX engine's tokens."""
    jcfg, cfg, jparams, params = setup
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit")
    want = [r.generated for r in jeng.run(_workload(JxRequest,
                                                    cfg.vocab_size))]
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                      **kw)
    assert [r.generated for r in eng.run(_workload(Request,
                                                   cfg.vocab_size))] == want
    if kw.get("plan") == "autotuned":
        assert eng.stats.plan == "autotuned:chain"
    assert eng.monitor.summary()["batches"] == sorted(
        set(eng.stats.slot_occupancy))


def test_serve_cli_reports_the_engine_fields():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng, done = serve.main(["--reduced", "--device", "cpu", "--requests",
                                "3", "--max-batch", "2", "--max-new", "4"])
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rep["requests"] == 3 and rep["tokens_out"] == 12
    assert rep["device"] == "cpu" and rep["plan"] == "jit"
    assert rep["decode_steps"] == eng.stats.decode_steps > 0
    assert set(rep["kernel_launches_per_decode_step"]) == {
        "decode_attention", "flash_attention", "paged_decode_attention",
        "paged_decode_attention_quant", "residual_rmsnorm", "rmsnorm_matmul",
        "rmsnorm", "wkv6", "decode_attention_mq", "paged_decode_attention_mq",
        "paged_decode_attention_quant_mq"}
    assert rep["measured_launch_tax_per_step_us"] > 0
