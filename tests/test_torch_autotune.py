"""The port's plan autotuner against the reference's.

``PlanTable`` round-trips and cross-loads with a table the JAX package
saved (the same JSON, ``PLAN_TABLE_VERSION`` 1) with the same lookups;
``select`` picks the reference's plan on fixed candidate lists, ties
included; ``autotune`` from a given characterization fills every entry
from its region's candidates; ``ServeEngine(plan="autotuned")`` serves the
JAX engine's greedy tokens and refuses a table of another arch, width or
platform as the reference does; the autotune and serve CLIs run end to
end with ``--device cpu``.
"""
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
from repro.runtime import autotune as jx_autotune
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.skip import SKIP
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.launch import autotune as cli
from repro_torch.launch import serve
from repro_torch.runtime import autotune as at

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


def _cand(mod, plan, step_us, disp):
    return mod.CandidateResult(
        plan=plan, mean_decode_step_s=step_us * 1e-6,
        decode_launch_tax_s=step_us * 5e-7, dispatches_per_decode_step=disp,
        fused_dispatches_per_decode_step=0.0, tokens_per_s=1e6 / step_us,
        decode_steps=10)


def _table(mod, cfg, entries, platform="Intel+H100"):
    t = mod.PlanTable(arch=cfg.name, scenario="chatbot", platform=platform,
                      d_model=cfg.d_model)
    for b, (region, plans) in entries.items():
        cands = [_cand(mod, p, 1000.0 + 10 * i, 100 - i)
                 for i, p in enumerate(plans)]
        t.entries[b] = mod.AutotuneEntry(batch=b, region=region,
                                         selected=mod.select(cands),
                                         candidates=cands)
    return t


ENTRIES = {1: ("CPU-bound", ("fused", "chain", "eager")),
           4: ("CPU-bound", ("chain", "eager", "fused")),
           8: ("GPU-bound", ("whole_graph", "jit"))}


def test_plan_tables_round_trip_and_cross_load(setup, tmp_path):
    jcfg, cfg, _, _ = setup
    assert at.PLAN_TABLE_VERSION == jx_autotune.PLAN_TABLE_VERSION == 1
    assert (at.CPU_BOUND_CANDIDATES, at.GPU_BOUND_CANDIDATES) == \
        (jx_autotune.CPU_BOUND_CANDIDATES, jx_autotune.GPU_BOUND_CANDIDATES)
    assert at.TIE_REL_TOL == jx_autotune.TIE_REL_TOL
    ours, ref = _table(at, cfg, ENTRIES), _table(jx_autotune, jcfg, ENTRIES)
    assert ours.to_dict() == ref.to_dict()
    p_ours, p_ref = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    ours.save(p_ours)
    ref.save(p_ref)
    assert open(p_ours).read() == open(p_ref).read()
    loaded = at.PlanTable.load(p_ref)           # the JAX table in the port
    back = jx_autotune.PlanTable.load(p_ours)   # and the other way round
    assert loaded.to_dict() == back.to_dict() == ours.to_dict()
    for b in range(1, 17):
        assert loaded.lookup(b) == back.lookup(b) == ref.lookup(b), b
    assert loaded.lookup(2) == ours.entries[1].selected
    assert at.PlanTable.from_any(loaded) is loaded
    assert at.PlanTable.from_any(ref.to_dict()).to_dict() == ref.to_dict()
    assert at.PlanTable(arch="x", scenario="", platform="").lookup(3) == \
        "auto"
    with pytest.raises(ValueError, match="version"):
        at.PlanTable.from_dict({"version": 0})
    with pytest.raises(TypeError):
        at.PlanTable.from_any(3)


@pytest.mark.parametrize("case", [
    [("eager", 1000, 900), ("chain", 1010, 100), ("fused", 1100, 50)],
    [("eager", 1000, 900), ("chain", 1030, 100), ("fused", 1019, 50)],
    [("jit", 500, 1), ("whole_graph", 500, 1)],
    [("jit", 600, 1), ("whole_graph", 500, 1)],
    [("fused", 1000, 50), ("chain", 1000, 50), ("eager", 999, 50)],
    [("chain", 1, 3)],
])
def test_select_agrees_with_the_reference(case):
    ours = [_cand(at, p, s, d) for p, s, d in case]
    ref = [_cand(jx_autotune, p, s, d) for p, s, d in case]
    assert at.select(ours) == jx_autotune.select(ref)
    assert at.select(ours, tie_rel_tol=0.0) == \
        jx_autotune.select(ref, tie_rel_tol=0.0)
    with pytest.raises(ValueError, match="no candidates"):
        at.select([])


def test_autotune_from_a_characterization_fills_every_entry(setup):
    _, cfg, _, params = setup
    kw = dict(scenario="code-completion", n_requests=3, prompt_cap=12,
              output_cap=4, max_len=MAX_LEN, device="cpu")
    res = SKIP.characterize(cfg, params, batches=(1, 2), plan="eager", **kw)
    out = SKIP.autotune(cfg, params, batches=(1, 2), characterization=res,
                        **kw)
    assert out.characterization is res
    table = out.table
    assert sorted(table.entries) == [1, 2]
    assert (table.arch, table.d_model, table.platform) == \
        (cfg.name, cfg.d_model, "Intel+H100")
    by_batch = {p.batch: p for p in res.points}
    for b, e in table.entries.items():
        assert e.region == res.boundedness.classify(b)
        fam = (at.CPU_BOUND_CANDIDATES if e.region == "CPU-bound"
               else at.GPU_BOUND_CANDIDATES)
        assert [c.plan for c in e.candidates] == list(fam)
        assert e.selected == at.select(e.candidates)
        for c in e.candidates:
            assert c.decode_steps > 0 and c.mean_decode_step_s > 0
            if c.plan == "eager":   # reused from the characterization
                assert c.mean_decode_step_s == \
                    by_batch[b].mean_decode_step_s
    s = out.summary()
    json.dumps(s, allow_nan=False)
    assert s["table"] == table.to_dict()


@pytest.mark.parametrize("selected", ["fused", "chain"])
def test_autotuned_serves_the_reference_tokens(setup, selected):
    jcfg, cfg, jparams, params = setup
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 12, 9, 3)]
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit")
    want = [r.generated for r in jeng.run(
        [JxRequest(i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])]
    entries = {1: ("CPU-bound", ("eager",)),
               2: ("CPU-bound", (selected,))}
    table = _table(at, cfg, entries)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      plan="autotuned", plan_table=table.to_dict(),
                      device="cpu")
    assert eng.plan == selected and eng.stats.plan == f"autotuned:{selected}"
    got = [r.generated for r in eng.run(
        [Request(i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])]
    assert got == want
    assert eng.stats.dispatches_per_decode_step > 1
    if selected == "fused":
        assert eng.stats.rule_hits


def test_autotuned_refuses_a_table_of_another_model(setup, tmp_path):
    jcfg, cfg, jparams, params = setup
    good = _table(at, cfg, {1: ("CPU-bound", ("chain",))})
    cases = {
        "arch": dict(good.to_dict(), arch="gpt2"),
        "d_model": dict(good.to_dict(), d_model=cfg.d_model * 2),
        "platform": dict(good.to_dict(), platform="GH200"),
        "plan_table": None,
    }
    for match, table in cases.items():
        with pytest.raises(ValueError, match=match):
            ServeEngine(cfg, params, max_batch=1, max_len=MAX_LEN,
                        plan="autotuned", plan_table=table, device="cpu")
        with pytest.raises(ValueError, match=match):
            JxServeEngine(jcfg, jparams, max_batch=1, max_len=MAX_LEN,
                          plan="autotuned", plan_table=table,
                          platform="Intel+H100")
    path = good.save(str(tmp_path / "t.json"))
    eng = ServeEngine(cfg, params, max_batch=3, max_len=MAX_LEN,
                      plan="autotuned", plan_table=path, device="cpu")
    assert eng.plan == "chain"


def test_the_clis_write_and_serve_the_table(tmp_path, capsys):
    out = tmp_path / "at"
    cli.main(["--reduced", "--device", "cpu", "--scenario",
              "code-completion", "--batches", "1,2", "--requests", "3",
              "--max-len", "64", "--out-dir", str(out)])
    text = capsys.readouterr().out
    last = json.loads(text.strip().splitlines()[-1])
    assert set(last["selected"]) == {"1", "2"} and "selected=" in text
    assert sorted(p.name for p in out.iterdir()) == ["autotune.json",
                                                     "plan_table.json"]
    table = at.PlanTable.load(str(out / "plan_table.json"))
    assert jx_autotune.PlanTable.load(str(out / "plan_table.json")) \
        .to_dict() == table.to_dict()
    serve.main(["--reduced", "--device", "cpu", "--plan", "autotuned",
                "--plan-table", str(out / "plan_table.json"),
                "--max-batch", "2", "--requests", "3", "--max-new", "4"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["plan"] == f"autotuned:{table.lookup(2)}"
    assert rep["tokens_out"] == 12
    b = rep["boundedness"]
    assert b["batches"] and set(b["classification"].values()) <= {
        "CPU-bound", "GPU-bound"}
    with pytest.raises(ValueError, match="plan_table"):
        serve.main(["--reduced", "--device", "cpu", "--plan", "autotuned"])
