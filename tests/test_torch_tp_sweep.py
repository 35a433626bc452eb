"""The port's modeled tensor-parallel sweep against the reference's.

* ``simulate_plan(tp=, collective_bytes=)`` over the port's traced decode
  stream gives the reference's events, field for field, for eager,
  whole-graph, chain and rule-tagged plans, a scalar and a per-segment
  payload, and tp 1, 2, 4 and 8 on both coupling classes; ``Planner``
  carries ``tp``, ``collective_bytes`` and ``draft_launches`` into its
  evaluation as the reference's does;
* ``decode_collective_sites`` equals the reference's;
* ``tp_sweep`` rows carry the reference's keys, one dispatch stream per
  device of the traced step's length and 2 · L · B · d · itemsize bytes a
  step, and the ``--tp-sweep`` CLI writes ``tp_sweep.json``.
Nothing executes sharded: one CPU prices every tp.
"""
import contextlib
import io
import json
import os

import jax
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core.device_model import PLATFORMS as JX_PLATFORMS
from repro.models import init_params as jx_init_params
from repro.runtime.plan import LaunchPlan as JxLaunchPlan
from repro.runtime.planner import Planner as JxPlanner
from repro.runtime.planner import simulate_plan as jx_simulate_plan
import repro.telemetry.characterize as jx_char
from repro_torch.configs import get_config, reduced
from repro_torch.core.device_model import PLATFORMS
from repro_torch.launch import characterize as cli
from repro_torch.models import init_params
from repro_torch.runtime.plan import LaunchPlan
from repro_torch.runtime.planner import Planner, simulate_plan
import repro_torch.telemetry.characterize as char

torch.set_num_threads(2)
PLATS = ("Intel+H100", "GH200")


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("smollm-360m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    trace = char._decode_trace(cfg, params, 2, 32, torch.device("cpu"))
    return cfg, params, trace


def _event_tuples(events):
    return [(e.name, e.launch_begin, e.launch_end, e.kernel_start,
             e.kernel_end, e.operator) for e in events]


def _plans(trace):
    n = len(trace.kernels)
    chain = LaunchPlan.chain([k.name for k in trace.kernels], 4)
    ruled = LaunchPlan("fused", chain.segments,
                       rules=((1, "rule_a"), (3, "rule_b")))
    return {
        "eager": (LaunchPlan.eager(n), JxLaunchPlan.eager(n)),
        "whole_graph": (LaunchPlan.whole_graph(n),
                        JxLaunchPlan.whole_graph(n)),
        "chain": (chain, JxLaunchPlan("chain", chain.segments, length=4)),
        "rules": (ruled, JxLaunchPlan("fused", chain.segments,
                                      rules=ruled.rules)),
    }


@pytest.mark.parametrize("plan_name", ["eager", "whole_graph", "chain",
                                       "rules"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_simulate_plan_matches_the_reference(setup, plan_name, tp):
    cfg, _, trace = setup
    plan, jplan = _plans(trace)[plan_name]
    n_segs = len(plan.segments)
    sites = char.decode_collective_sites(cfg, 2, n_segs)
    for plat in PLATS:
        for coll in (None, 3 * 4096, sites):
            for kw in ({}, {"batch_scale": 3.0}, {"draft_launches": 5}):
                ours = simulate_plan(trace.kernels, plan, PLATFORMS[plat],
                                     tp=tp, collective_bytes=coll, **kw)
                ref = jx_simulate_plan(trace.kernels, jplan,
                                       JX_PLATFORMS[plat], tp=tp,
                                       collective_bytes=coll, **kw)
                assert _event_tuples(ours) == _event_tuples(ref)


def test_simulate_plan_rejects_what_the_reference_rejects(setup):
    _, _, trace = setup
    plan = LaunchPlan.eager(len(trace.kernels))
    spec = PLATFORMS["Intel+H100"]
    with pytest.raises(ValueError, match="tp must be >= 1"):
        simulate_plan(trace.kernels, plan, spec, tp=0)
    with pytest.raises(ValueError, match="entries"):
        simulate_plan(trace.kernels, plan, spec, tp=2,
                      collective_bytes=[1.0, 2.0])


def test_planner_carries_tp_and_collectives(setup):
    cfg, _, trace = setup
    n = len(trace.kernels)
    sites = char.decode_collective_sites(cfg, 2, n)
    for kw in ({}, {"tp": 2, "collective_bytes": sites},
               {"tp": 4, "collective_bytes": 1e5, "draft_launches": 3}):
        ours = Planner(trace, "Intel+H100", **kw).evaluate(
            LaunchPlan.eager(n))
        ref = JxPlanner(trace, "Intel+H100", **kw).evaluate(
            JxLaunchPlan.eager(n))
        assert (ours.tklqt, ours.il) == (ref.tklqt, ref.il)


@pytest.mark.parametrize("batch,n_segments", [(1, 1), (1, 7), (4, 100),
                                              (16, 3), (2, 0)])
def test_decode_collective_sites_match_the_reference(batch, n_segments):
    for arch in ("smollm-360m", "llama-3.2-1b", "gemma2-27b"):
        cfg = reduced(get_config(arch))
        jcfg = jx_reduced(jx_get_config(arch))
        ours = char.decode_collective_sites(cfg, batch, n_segments)
        assert ours == jx_char.decode_collective_sites(jcfg, batch,
                                                       n_segments)
        if n_segments:
            assert sum(ours) == 2 * cfg.n_layers * batch * cfg.d_model * \
                cfg.cdtype.itemsize


def test_tp_sweep_rows_carry_the_reference_keys(setup):
    cfg, params, _ = setup
    batches, tps = (1, 2), (1, 2)
    sweep = char.tp_sweep(cfg, params, batches=batches, tps=tps,
                          platforms=PLATS, max_len=32, device="cpu")
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    ref = jx_char.tp_sweep(jcfg, jx_init_params(jax.random.PRNGKey(0), jcfg),
                           batches=batches, tps=tps, platforms=PLATS,
                           max_len=32)
    assert set(sweep) == set(ref)
    assert [set(p) for p in sweep["points"]] == \
        [set(p) for p in ref["points"]]
    assert [(p["platform"], p["tp"], p["batch"]) for p in sweep["points"]] \
        == [(p["platform"], p["tp"], p["batch"]) for p in ref["points"]]
    assert {k: set(v) for k, v in sweep["inflection_batch"].items()} == \
        {k: set(v) for k, v in ref["inflection_batch"].items()}
    for p in sweep["points"]:
        n = len(char._decode_trace(cfg, params, p["batch"], 32,
                                   "cpu").kernels)
        assert p["per_device_dispatches"] == p["n_kernels"] == n
        want = (2 * cfg.n_layers * p["batch"] * cfg.d_model
                * cfg.cdtype.itemsize if p["tp"] > 1 else 0)
        assert p["collective_bytes"] == want
        assert (p["modeled_collective_tax_us"] > 0) == (p["tp"] > 1)
    # more device streams: more launch tax for the same step
    by = {(p["platform"], p["tp"], p["batch"]): p for p in sweep["points"]}
    for plat in PLATS:
        for b in batches:
            assert by[(plat, 2, b)]["launch_tax_us"] > \
                by[(plat, 1, b)]["launch_tax_us"]


def test_tp_sweep_cli_writes_the_sweep(tmp_path):
    out = str(tmp_path / "tp")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sweep = cli.main(["--reduced", "--device", "cpu", "--tp-sweep",
                          "--tps", "1,2", "--batches", "1,4",
                          "--max-len", "32", "--out-dir", out])
    lines = buf.getvalue().strip().splitlines()
    with open(os.path.join(out, "tp_sweep.json")) as fh:
        assert json.load(fh) == sweep
    assert json.loads(lines[-1])["summary"] == sweep
    assert any(line.startswith("inflection[Intel+H100]: tp=1 ->")
               for line in lines)
    assert sweep["tps"] == [1, 2] and len(sweep["points"]) == 2 * 2 * 2
