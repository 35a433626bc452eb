"""Each launch plan of the port against the same plan of the reference.

The reference's own acceptance setup for its plans (``tests/test_runtime.py``
``test_engine_chain_plan_fewer_dispatches_same_tokens``): reduced SmolLM
(2 layers, f32), ``ServeEngine(max_batch=2, max_len=64)``, one request of
the prompt ``range(7, 17)`` and 4 new tokens, with the reference's weights
bridged bit for bit.  Under each plan the port serves the tokens the JAX
engine serves under the same plan, in as many decode steps (chain and
fused: ``tests/test_torch_skip.py``; auto: ``tests/test_torch_runtime.py``,
to keep each file within its time).
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
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def smollm():
    jcfg = jx_reduced(jx_get_config("smollm-360m"), n_layers=2)
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def serve_both(smollm, plan):
    """(reference engine, port engine) after serving the request."""
    jcfg, cfg, jparams, params = smollm
    kw = dict(max_batch=2, max_len=64)
    jeng = JxServeEngine(jcfg, jparams, plan=plan, platform="Intel+H100",
                         **kw)
    jeng.done = jeng.run([JxRequest(0, prompt=list(range(7, 17)),
                                    max_new_tokens=4)])
    eng = ServeEngine(cfg, params, plan=plan, device="cpu", **kw)
    eng.done = eng.run([Request(0, prompt=list(range(7, 17)),
                                max_new_tokens=4)])
    return jeng, eng


def check_same_plan(jeng, eng) -> None:
    assert [r.generated for r in eng.done] == \
        [r.generated for r in jeng.done]
    assert eng.stats.decode_steps == jeng.stats.decode_steps > 0
    assert eng.stats.plan == jeng.stats.plan
    assert eng.stats.modeled_tklqt_s > 0.0


@pytest.mark.parametrize("plan", ["eager", "whole_graph"])
def test_plan_serves_the_reference_plans_tokens(smollm, plan):
    jeng, eng = serve_both(smollm, plan)
    check_same_plan(jeng, eng)
    n = len(eng.backend.planned_decode.trace.kernels)
    per_step = eng.stats.dispatches_per_decode_step
    if plan == "eager":
        assert per_step == n                    # one dispatch a node
    else:
        assert per_step == jeng.stats.dispatches_per_decode_step == 1
