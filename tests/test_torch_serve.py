"""The port's serving engine against the reference's, on reduced SmolLM.

Six requests of ragged prompt lengths and budgets through ``max_batch 2``
(so slots are reused): greedy tokens byte-identical to the JAX
``ServeEngine(plan="jit")`` on the same bridged weights, with the same
scheduling counters.  Also: without ``device=`` the engine asks for the GPU
and raises where there is none, and every feature not ported yet raises
(the paged cache's parity is in ``test_torch_paged_serve.py``).
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
    dict(cache="paged", speculative=True),
    dict(cache="paged", tracer=object()), dict(speculative=True),
    dict(tp=2), dict(plan="autotuned"), dict(monitor=True), dict(tracer=object()),
    dict(plan_table={})])
def test_unported_options_raise(setup, kw):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="ROADMAP"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device="cpu",
                    **kw)


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
        "rmsnorm", "wkv6"}
    assert rep["measured_launch_tax_per_step_us"] > 0
