"""SKIP on the aten stream against the reference, on the CPU.

The port's copies of ``repro.core`` (device model, metrics, boundedness,
proximity mining, export), ``repro.runtime`` (plan builders, planner) and
``repro.telemetry.attribution`` are held against the reference on the same
inputs: the reference trace's kernel-name list for mining and plans, one
seeded list of kernel costs for the timeline model, equal results (exact,
or within 1e-12 relative for floats).  Then the port's own pieces: the
SKIP facade over a traced torch function, the fusion rules in f32 and bf16
(a window whose intermediate escapes does not match), and the fused
serving plan beside the reference's fused engine on the same weights.
"""
import dataclasses
from fractions import Fraction
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core import boundedness as jx_bnd
from repro.core import device_model as jx_dm
from repro.core import export as jx_export
from repro.core import metrics as jx_metrics
from repro.core import proximity as jx_prox
from repro.core.tracing import trace_fn as jx_trace_fn
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro.runtime import plan as jx_plan
from repro.runtime import planner as jx_planner
from repro.telemetry import attribution as jx_attr
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduced
from repro_torch.core import SKIP
from repro_torch.core import boundedness as bnd
from repro_torch.core import device_model as dm
from repro_torch.core import export
from repro_torch.core import metrics
from repro_torch.core import proximity as prox
from repro_torch.core.tracing import Executor, trace_fn
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.models import init_params
from repro_torch.runtime import (LaunchPlan, PlanExecutor, Planner,
                                 find_matches, fused_plan)
from repro_torch.runtime import planner as planner_mod
from repro_torch.telemetry import attribution as attr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx_names():
    """The reference trace's kernel names: a reduced SmolLM decode step."""
    cfg = jx_reduced(jx_get_config("smollm-360m"))
    params = jx_init_params(jax.random.PRNGKey(0), cfg)
    cache = jx_make_cache(cfg, 2, 16)
    tr = jx_trace_fn(lambda p, c, t, n: jx_forward(p, t, cfg, cache=c,
                                                   lengths=n)[0],
                     params, cache, jnp.zeros((2, 1), jnp.int32),
                     jnp.asarray([3, 5], jnp.int32))
    return tr.kernel_names


def _costs(n=300, seed=0):
    """One seeded kernel list: names from a small alphabet, operator
    scopes, costs spanning launch-bound to device-bound kernels."""
    rng = np.random.default_rng(seed)
    names = ["mm", "add", "mul", "rsqrt", "_to_copy", "index_put_"]
    ops = ["layer0/attn", "layer0/mlp", "layer1/norm1", "embed", ""]
    return [SimpleNamespace(
        name=names[int(rng.integers(len(names)))],
        operator=ops[int(rng.integers(len(ops)))],
        flops=float(rng.choice([1e3, 1e6, 1e9, 5e10])),
        bytes=float(rng.choice([1e3, 1e5, 1e7, 3e8])),
        host_dispatch_s=0.0) for _ in range(n)]


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return _close(dataclasses.asdict(a), dataclasses.asdict(b))
    return a == b


def test_platform_rows_equal_the_reference():
    assert dm.PLATFORMS.keys() == jx_dm.PLATFORMS.keys()
    for name, spec in dm.PLATFORMS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jx_dm.PLATFORMS[name]), name
    for plat in dm.PLATFORMS:
        for tp in (1, 2, 4):
            assert _close(dm.allreduce_cost_s(dm.PLATFORMS[plat], 1e6, tp),
                          jx_dm.allreduce_cost_s(jx_dm.PLATFORMS[plat], 1e6,
                                                 tp))
            assert _close(dm.dispatch_fanout_s(dm.PLATFORMS[plat], tp),
                          jx_dm.dispatch_fanout_s(jx_dm.PLATFORMS[plat], tp))


@pytest.mark.parametrize("platform", ["Intel+H100", "GH200", "TPU-v5e"])
def test_timeline_model_equals_the_reference(platform):
    ks = _costs()
    hs = list(np.random.default_rng(1).uniform(0.5, 3.0, len(ks)))
    for scale in (1.0, 8.0):
        ev = dm.simulate(ks, dm.PLATFORMS[platform], batch_scale=scale,
                         host_scale=hs)
        jev = jx_dm.simulate(ks, jx_dm.PLATFORMS[platform],
                             batch_scale=scale, host_scale=hs)
        assert _close(ev, jev)
        launch = dm.PLATFORMS[platform].launch_overhead_ns * 1e-9
        assert _close(metrics.report(ev, platform, launch),
                      jx_metrics.report(jev, platform, launch))
        assert _close(dm.decompose_events(ev), jx_dm.decompose_events(jev))
    assert _close(export.to_chrome_trace(ev, platform),
                  jx_export.to_chrome_trace(jev, platform))


@pytest.mark.parametrize("curve", [
    [1.0, 1.1, 1.2, 2.0, 4.0], [1.0, 1.0, 1.0], [0.0, 5.0], [3.0, 2.0, 9.0],
    []])
def test_inflection_equals_the_reference(curve):
    batches = [1, 2, 4, 8, 16][:len(curve)]
    assert (bnd.find_inflection(batches, curve)
            == jx_bnd.find_inflection(batches, curve))
    reps = [SimpleNamespace(tklqt=t, queue_share=0.5) for t in curve]
    assert _close(bnd.classify_sweep(batches, reps),
                  jx_bnd.classify_sweep(batches, reps))


@pytest.mark.parametrize("length", [2, 4, 8, 16, 32])
def test_mining_and_plans_equal_the_reference(jx_names, length):
    got = prox.mine_chains(jx_names, length)
    want = jx_prox.mine_chains(jx_names, length)
    assert _close(got, want)
    assert (prox.fusion_segments(jx_names, length)
            == jx_prox.fusion_segments(jx_names, length))
    n = len(jx_names)
    pairs = [(LaunchPlan.eager(n), jx_plan.LaunchPlan.eager(n)),
             (LaunchPlan.whole_graph(n), jx_plan.LaunchPlan.whole_graph(n)),
             (LaunchPlan.chain(jx_names, length),
              jx_plan.LaunchPlan.chain(jx_names, length))]
    for p, q in pairs:
        assert p.segments == q.segments and p.describe() == q.describe()
        assert p.validate(n) is p
    with pytest.raises(ValueError):
        LaunchPlan.from_segments([[0, 2], [1]])
    with pytest.raises(ValueError):
        jx_plan.LaunchPlan.from_segments([[0, 2], [1]])


def test_planner_and_attribution_equal_the_reference():
    ks = _costs(400, seed=3)
    tr = SimpleNamespace(kernels=ks, kernel_names=[k.name for k in ks])
    mine = Planner(tr, "Intel+H100")
    ref = jx_planner.Planner(tr, "Intel+H100")
    assert mine.cost_partition().segments == ref.cost_partition().segments
    got, want = mine.auto(), ref.auto()
    assert got.plan.segments == want.plan.segments
    assert _close(got.report, want.report)
    plan = got.plan
    ev = planner_mod.simulate_plan(ks, plan, dm.PLATFORMS["Intel+H100"])
    jev = jx_planner.simulate_plan(ks, want.plan,
                                   jx_dm.PLATFORMS["Intel+H100"])
    assert _close(ev, jev)
    rep = attr.attribute_events(ks, plan, ev, by_layer=True)
    jrep = jx_attr.attribute_events(ks, want.plan, jev, by_layer=True)
    assert rep.complete and jrep.complete
    assert [(r.operator, r.launches, r.kernels) for r in rep.rows] == \
        [(r.operator, r.launches, r.kernels) for r in jrep.rows]
    assert rep.accounted_launches == Fraction(len(plan.segments))


def _norm_fn(escape=False):
    def fn(x, w, wp):
        q, h = kernels.rmsnorm_matmul(x, w, wp, eps=1e-5)
        if escape:                 # the norm's intermediate leaves it
            xf = x.float()
            var = xf.square().mean(-1, keepdim=True)
            out = (xf * torch.rsqrt(var + 1e-5) * w.float()).to(x.dtype)
            return q, h, out, var
        return q, h
    return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rules_fuse_the_norm_windows(dtype):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((2, 3, 16), (16,), (16, 8))]
    tr = trace_fn(_norm_fn(), *args)
    assert "rmsnorm_matmul" not in tr.kernel_names      # expanded
    ms = find_matches(tr)
    assert [m.rule_name for m in ms] == ["rmsnorm_matmul"]
    assert ms[0].max_abs_err == 0.0                      # plain on the CPU
    plan = fused_plan(tr)
    assert plan.rules == ((0, "rmsnorm_matmul"),)
    got = PlanExecutor(tr, plan).call(*args)
    want = PlanExecutor(tr).call(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a second, inline norm whose variance escapes is left alone
    tr2 = trace_fn(_norm_fn(escape=True), *args)
    assert [m.rule_name for m in find_matches(tr2)] == ["rmsnorm_matmul"]


def test_a_wrong_fused_kernel_raises_on_the_card(monkeypatch):
    """A window that binds but whose hand-written kernel disagrees is left
    unfused on the CPU and raises on a CUDA-tagged trace.  The trace is
    retagged as traced on the card; the check's tensors stay on the CPU,
    and a spy stands in for a wrong ``rmsnorm_matmul`` kernel."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.runtime import rules

    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 3, 16), (16,), (16, 8))]
    tr = trace_fn(_norm_fn(), *args)
    calls = []

    def wrong_kernel(x, w, wp, eps):
        calls.append(x.shape)
        proj, normed = kernels.rmsnorm_matmul(x, w, wp, eps=eps)
        return proj + 1.0, normed

    monkeypatch.setattr(rules, "rmsnorm_matmul", wrong_kernel)
    monkeypatch.setattr(rules, "_VERIFY_CACHE", {})
    # CPU: the product stays unfused, the bare norm before it still fuses
    assert [m.rule_name for m in find_matches(tr)] == ["rmsnorm"]
    assert calls
    mode = FakeTensorMode()
    for node in tr.graph_module.graph.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            node.meta["val"] = FakeTensor(mode, val.to("meta"),
                                          torch.device("cuda", 0))
    real_random_like = rules._random_like
    monkeypatch.setattr(rules, "_random_like",
                        lambda val, r: real_random_like(
                            torch.empty(val.shape, dtype=val.dtype), r))
    with pytest.raises(RuntimeError,
                       match=r"'rmsnorm_matmul' .* on cuda:0: the "
                             r"hand-written kernel disagrees .*> tolerance"):
        find_matches(tr)


def test_skip_facade_over_a_torch_function():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))

    def fn(a, b):
        h = a
        for _ in range(6):
            h = torch.tanh(h @ b) + a
        return h.sum(-1)

    skip = SKIP.trace(fn, x, w)
    assert skip.trace_.kernel_names.count("mm") == 6
    skip.measure_host(repeats=2)
    assert all(k.host_dispatch_s > 0 for k in skip.trace_.kernels)
    rep = skip.report("Intel+H100", use_host_scale=False)
    assert rep.n_kernels == len(skip.trace_.kernels) and rep.tklqt > 0
    sweep, reps = skip.batch_sweep("Intel+H100", batches=(1, 2, 4))
    assert len(reps) == 3 and sweep.batches == [1, 2, 4]
    out = skip.fuse(length=3, repeats=1)
    assert out.k_fused < out.k_eager and out.max_abs_err == 0.0
    choice = skip.plan("Intel+H100")
    got = skip.executor(choice.plan).call(x, w)
    assert torch.equal(got, fn(x, w))
    ex = Executor(skip.trace_)
    assert ex.n_launches == len(skip.trace_.kernels)
    assert torch.equal(ex.run(x, w)[0][0], fn(x, w))
    # the measured side delegates: a serving sweep, then a plan table
    cfg = reduced(get_config("smollm-360m"))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    kw = dict(scenario="code-completion", n_requests=2, prompt_cap=8,
              output_cap=3, max_len=32, device="cpu")
    res = SKIP.characterize(cfg, params, batches=(1, 2), plan="jit", **kw)
    assert [p.batch for p in res.points] == [1, 2]
    assert all(p.dispatches_per_decode_step == 1 for p in res.points)
    tuned = SKIP.autotune(cfg, params, batches=(2,), characterization=res,
                          **kw)
    assert list(tuned.table.entries) == [2]
    assert tuned.table.lookup(2) in ("eager", "chain", "fused", "jit",
                                     "whole_graph")


def test_fused_rule_hits_match_the_reference():
    """The same requests under the reference's fused plan and the port's,
    on bridged weights: the same tokens, the same rule hits call for call,
    and per call the reference's windows: rmsnorm_matmul L,
    residual_rmsnorm L, rmsnorm 1."""
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    kw = dict(max_batch=2, max_len=32)

    def reqs(cls):
        return [cls(0, prompt=list(range(7, 17)), max_new_tokens=4),
                cls(1, prompt=list(range(3, 9)), max_new_tokens=3)]

    jeng = JxServeEngine(jcfg, jparams, plan="fused", platform="Intel+H100",
                         **kw)
    want = jeng.run(reqs(JxRequest))
    eng = ServeEngine(cfg, params, plan="fused", device="cpu", **kw)
    done = eng.run(reqs(Request))
    assert [r.generated for r in done] == [r.generated for r in want]
    assert eng.stats.rule_hits == dict(jeng.stats.rule_hits)
    assert eng.stats.fused_dispatches == jeng.stats.fused_dispatches
    L = cfg.n_layers
    for pf in eng.backend._planned_fns.values():
        hits = {n: pf.rule_names.count(n) for n in set(pf.rule_names)}
        assert hits == {"rmsnorm_matmul": L, "residual_rmsnorm": L,
                        "rmsnorm": 1}


def test_chain_plan_serves_the_reference_plans_tokens():
    """The chain plan beside the reference's chain plan, on the
    reference's own acceptance setup (``tests/test_torch_plan_parity.py``):
    the same tokens, fewer dispatches per decode step than the node
    count, and a modeled TKLQT below eager's."""
    from test_torch_plan_parity import check_same_plan, serve_both
    smollm = (jx_reduced(jx_get_config("smollm-360m"), n_layers=2),
              reduced(get_config("smollm-360m"), n_layers=2))
    jparams = jx_init_params(jax.random.PRNGKey(0), smollm[0])
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    smollm[1], device="cpu")
    jeng, eng = serve_both((smollm[0], smollm[1], jparams, params), "chain")
    check_same_plan(jeng, eng)
    pf = eng.backend.planned_decode
    assert 1 < eng.stats.dispatches_per_decode_step < len(pf.trace.kernels)
    assert pf.plan.strategy == "chain"

