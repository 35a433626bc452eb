"""The port's measured characterization against the reference's.

* ``classify_measured_sweep`` on fixed step-time and launch-tax curves
  gives the reference's inflection batch, classifications and queue shares;
* ``BoundednessMonitor`` fed one observation sequence gives the reference's
  ``result()``, ``verdict()``, ``summary()`` and gauges;
* ``characterize`` on reduced SmolLM-360M under ``eager``, ``chain`` and
  ``jit`` over the closed-loop ``code-completion`` scenario has the
  reference's ``summary()`` and ``row()`` keys, and per batch the JAX
  engine's ``tokens_out``, ``decode_steps`` and ``mean_occupancy`` (closed
  loop: the scheduling does not depend on measured times);
* ``memory_pressure_sweep`` gives the reference's pool sizes, preemptions,
  tokens and decode steps per point;
* the merged trace is strict JSON with one flow pair per (anchor, event),
  and the plan executor's recorder gets one dispatch span per segment;
* the measured pass reuses the warmup pass's traces, plans and graphs;
* ``launch.characterize`` runs end to end with ``--device cpu``.
"""
import json
from collections import namedtuple

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.models import init_params as jx_init_params
import repro.telemetry.characterize as jx_char
from repro.telemetry.characterize import MeasuredPoint as JxMeasuredPoint
from repro.telemetry.metrics import summarize as jx_summarize
from repro.telemetry.monitor import BoundednessMonitor as JxMonitor
from repro.telemetry.registry import MetricsRegistry as JxRegistry
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.export import merged_chrome_trace
from repro_torch.inference.backends import local
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.launch import characterize as cli
import repro_torch.telemetry.characterize as char
from repro_torch.telemetry.monitor import BoundednessMonitor
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.spans import SpanRecorder

torch.set_num_threads(2)
KW = dict(scenario="code-completion", batches=(1, 2), n_requests=4,
          prompt_cap=12, output_cap=4, max_len=32, platform="Intel+H100")
CURVES = {
    "flat": ([1, 2, 4, 8], [1e-3, 1.1e-3, 1.2e-3, 1.3e-3],
             [9e-4, 9e-4, 9e-4, 9e-4]),
    "knee": ([1, 2, 4, 8, 16], [2e-3, 2.1e-3, 2.9e-3, 3.1e-3, 6e-3],
             [1e-3, 1e-3, 1e-3, 1.2e-3, 1.1e-3]),
    "no_tax": ([1, 4, 16], [1e-3, 1.6e-3, 4e-3], None),
    "zero_base": ([1, 2], [0.0, 1e-3], [0.0, 5e-4]),
    "tax_above_step": ([1, 2, 4], [1e-3, 1e-3, 2e-3], [2e-3, 5e-4, 0.0]),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def runs(setup):
    """The reference's jit sweep and the port's under three plans."""
    jcfg, cfg, jparams, params = setup
    ref = jx_char.characterize(jcfg, jparams, plan="jit", **KW)
    ours = {plan: char.characterize(cfg, params, plan=plan, device="cpu",
                                    **KW)
            for plan in ("eager", "chain", "jit")}
    return ref, ours


@pytest.mark.parametrize("curve", list(CURVES))
def test_classify_measured_sweep_matches_the_reference(curve):
    batches, steps, taxes = CURVES[curve]
    ours = char.classify_measured_sweep(batches, steps, taxes)
    ref = jx_char.classify_measured_sweep(batches, steps, taxes)
    assert ours.inflection_batch == ref.inflection_batch
    assert ours.batches == ref.batches and ours.tklqt == ref.tklqt
    assert ours.queue_share == ref.queue_share
    assert [ours.classify(b) for b in batches] == \
        [ref.classify(b) for b in batches]
    assert ours.cpu_bound_region == ref.cpu_bound_region


def _feed(mon, registry):
    """One observation sequence: four live batches, ragged windows, the
    per-operator rows of two planned calls."""
    mon.bind_metrics(registry)
    rng = np.random.default_rng(3)
    Row = namedtuple("Row", "operator launches tklqt_s")
    for i in range(70):
        b = (1, 2, 4, 8)[i % 4] if i < 60 else 8
        step = 1e-3 * (1 + (b >= 4) * b * 0.3) + rng.uniform(0, 1e-5)
        mon.observe(b, step, 5e-4 + rng.uniform(0, 1e-5))
    mon.observe(0, 1.0)                       # an empty step is ignored
    rows = [Row("attention", 3, 2e-5), Row("mlp", 2, 4e-5),
            Row("norm", 5, 1e-5)]
    mon.observe_operators(rows)
    mon.observe_operators(rows[:2], calls=3)


def test_monitor_matches_the_reference():
    ours, ref = BoundednessMonitor(window=8, refresh_stride=5), \
        JxMonitor(window=8, refresh_stride=5)
    reg, jreg = MetricsRegistry(), JxRegistry()
    _feed(ours, reg)
    _feed(ref, jreg)
    a, b = ours.result(), ref.result()
    assert (a.batches, a.tklqt, a.queue_share, a.inflection_batch) == \
        (b.batches, b.tklqt, b.queue_share, b.inflection_batch)
    assert a.inflection_batch == 4
    for batch in (None, 1, 2, 4, 8):
        assert ours.verdict(batch) == ref.verdict(batch)
    assert ours.summary() == ref.summary()
    assert ours.top_operators(2) == ref.top_operators(2)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    for name in ("monitor_inflection_batch", "monitor_gpu_bound",
                 "monitor_window_step_seconds",
                 "monitor_operator_tklqt_seconds_total",
                 "monitor_operator_launches_total"):
        assert snap[name] == jsnap[name], name
    ours.clear()
    assert ours.verdict() == "unknown" == JxMonitor().verdict()
    with pytest.raises(ValueError, match="window"):
        BoundednessMonitor(window=0)
    with pytest.raises(ValueError, match="refresh_stride"):
        BoundednessMonitor(refresh_stride=0)


@pytest.mark.parametrize("plan", ["eager", "chain", "jit"])
def test_characterize_matches_the_reference(runs, plan):
    ref, ours = runs[0], runs[1][plan]
    s, js = ours.summary(), ref.summary()
    assert set(s) == set(js)
    assert s["plan"] == plan and s["platform"] == js["platform"]
    for key in ("arch", "scenario", "seed", "n_requests", "batches"):
        assert s[key] == js[key], key
    assert ours.workload.meta() == ref.workload.meta()
    for p, jp in zip(s["points"], js["points"]):
        # the reference's jit rows carry no attribution; a planned row does
        want = set(jp) | ({"attribution"} if plan != "jit" else set())
        assert set(p) == want
        for key in ("tokens_out", "decode_steps", "mean_occupancy",
                    "n_requests", "preemptions"):
            assert p[key] == jp[key], (plan, p["batch"], key)
        assert p["mean_decode_step_us"] > 0
        assert p["decode_launch_tax_us"] > 0
    for pt in ours.points:
        assert ours.boundedness.classify(pt.batch) in ("CPU-bound",
                                                       "GPU-bound")
        if plan == "jit":
            assert pt.dispatches_per_decode_step == 1
            assert not pt.modeled_events and pt.attribution is None
        else:
            assert pt.dispatches_per_decode_step > 1
            assert pt.modeled_events and pt.decode_anchors
            assert pt.attribution.complete
    json.dumps(s)


def test_a_planned_row_has_the_reference_keys(runs):
    """The reference's row of a planned point (with an attribution) has
    the port's eager row's keys."""
    ours = runs[1]["eager"].points[0]
    jp = JxMeasuredPoint(
        batch=1, latency=jx_summarize([]), mean_decode_step_s=1.0,
        launch_tax_per_step_s=0.0, decode_launch_tax_s=0.0,
        dispatches_per_decode_step=1.0, modeled_tklqt_s=0.0,
        tokens_per_s=0.0, mean_occupancy=0.0, tokens_out=0,
        decode_steps=0, attribution=ours.attribution)
    assert set(jp.row()) == set(ours.row())


def test_memory_pressure_sweep_matches_the_reference(setup):
    jcfg, cfg, jparams, params = setup
    kw = dict(scenario="code-completion", kv_dtypes=("bf16",))
    ref = jx_char.memory_pressure_sweep(jcfg, jparams, **kw)
    ours = char.memory_pressure_sweep(cfg, params, device="cpu", **kw)
    for key in ("full_pool_blocks", "block_bytes", "platforms",
                "pool_fracs", "kv_dtypes", "kv_dtype_deltas", "n_requests"):
        assert ours[key] == ref[key], key
    assert set(ours) == set(ref) | {"measured_offload_copy_us"}
    assert ours["measured_offload_copy_us"] == [None] * len(ours["points"])
    for p, jp in zip(ours["points"], ref["points"]):
        assert set(p) == set(jp)
        for key in ("platform", "pool_frac", "num_blocks", "preemptions",
                    "tokens_out", "decode_steps", "offload_bytes",
                    "restore_bytes", "modeled_offload_tax_us"):
            assert p[key] == jp[key], (p["platform"], p["pool_frac"], key)
    assert any(p["preemptions"] for p in ours["points"])


def _check_flow_pairing(trace):
    starts, finishes = {}, {}
    for ev in trace["traceEvents"]:
        assert ev["ph"] in ("X", "s", "f")
        if ev.get("cat") == "dispatch_flow":
            side = starts if ev["ph"] == "s" else finishes
            assert ev["id"] not in side, f"duplicate flow id {ev['id']}"
            side[ev["id"]] = ev
    assert set(starts) == set(finishes)
    return starts, finishes


def test_merged_trace_is_strict_json_with_a_flow_pair_per_anchor(runs):
    pt = runs[1]["eager"].points[1]
    anchors = pt.decode_anchors[:3]
    assert len(anchors) == 3
    trace = merged_chrome_trace(pt.spans, "Intel+H100",
                                device_events=pt.modeled_events,
                                device_anchors=anchors)
    trace = json.loads(json.dumps(trace, allow_nan=False))
    starts, finishes = _check_flow_pairing(trace)
    assert len(starts) == len(pt.modeled_events) * len(anchors)
    for fid, s in starts.items():
        assert s["tid"] == 1 and finishes[fid]["tid"] == 2
        assert finishes[fid]["ts"] >= s["ts"]
    assert set(trace["otherData"]["thread_names"]) == {"0", "1", "2"}
    cats = {ev["cat"] for ev in trace["traceEvents"]}
    assert {"prefill", "decode", "dispatch", "modeled_kernel"} <= cats
    # the engine lays each decode's segment spans inside its decode span
    decode = [s for s in pt.spans if s.cat == "decode"]
    segs = [s for s in pt.spans if s.cat == "dispatch"]
    assert len(segs) >= len(decode) * pt.dispatches_per_decode_step
    assert all(s.tid == 1 for s in segs)


@pytest.mark.parametrize("plan", ["eager", "jit"])
def test_the_measured_pass_reuses_the_warmup_pass(setup, plan):
    """run_point's warmup, reset, measured pass: no trace, plan or graph
    is made again, and the monitor and spans start over."""
    _, cfg, _, params = setup
    wl = char.sample_requests("code-completion", 4, seed=0,
                              vocab_size=cfg.vocab_size, prompt_cap=12,
                              output_cap=4)
    rec = SpanRecorder()
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, plan=plan,
                      telemetry=rec, device="cpu")
    first = eng.run(char._requests(wl))
    be = eng.backend
    before = (be.trace_stats.traces, be.trace_stats.seconds,
              be.graph_stats.captured, len(local._TRACES),
              dict(be._planned_fns), eng._planned_decode)
    eng.reset()
    assert rec.spans == [] and eng.monitor.result().batches == []
    again = eng.run(char._requests(wl))
    assert (be.trace_stats.traces, be.trace_stats.seconds,
            be.graph_stats.captured, len(local._TRACES),
            dict(be._planned_fns), eng._planned_decode) == before
    assert [r.generated for r in again] == [r.generated for r in first]
    assert eng.monitor.result().batches == sorted(
        set(eng.stats.slot_occupancy))
    assert rec.by_cat("decode") and rec.by_cat("prefill")


def test_the_cli_writes_its_artifacts(tmp_path, capsys):
    out = tmp_path / "out"
    cli.main(["--reduced", "--device", "cpu", "--scenario",
              "code-completion", "--batches", "1,2", "--plan", "eager",
              "--requests", "3", "--max-len", "64",
              "--attribution-report", "--out-dir", str(out)])
    text = capsys.readouterr().out
    assert "inflection_batch=" in text and "attribution[batch=2]" in text
    last = json.loads(text.strip().splitlines()[-1])
    assert set(last["artifacts"]) == {"workload", "trace_b1", "trace_b2",
                                      "summary"}
    assert sorted(p.name for p in out.iterdir()) == [
        "characterize.json", "trace_code-completion_b1.json",
        "trace_code-completion_b2.json", "workload_code-completion.jsonl"]
    trace = json.loads((out / "trace_code-completion_b2.json").read_text())
    _check_flow_pairing(trace)
    summary = json.loads((out / "characterize.json").read_text())
    assert summary["batches"] == [1, 2] and summary["plan"] == "eager"
    # the written workload replays the same traffic
    cli.main(["--reduced", "--device", "cpu", "--batches", "1", "--plan",
              "jit", "--replay", str(out / "workload_code-completion.jsonl"),
              "--out-dir", str(tmp_path / "replay")])
    replay = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert replay["summary"]["n_requests"] == 3
    assert replay["summary"]["scenario"] == "code-completion"
    cli.main(["--reduced", "--device", "cpu", "--memory-sweep",
              "--scenario", "code-completion", "--kv-dtypes", "bf16,int8",
              "--pool-fracs", "1.0,0.33", "--sweep-platforms", "GH200",
              "--out-dir", str(out)])
    text = capsys.readouterr().out
    assert "copy=not measured (cpu)" in text and "delta[GH200" in text
    sweep = json.loads((out / "memory_sweep.json").read_text())
    assert len(sweep["points"]) == 4 and len(sweep["kv_dtype_deltas"]) == 2
    # the modeled tensor-parallel sweep is ported: it writes its sweep
    cli.main(["--reduced", "--device", "cpu", "--tp-sweep", "--tps", "1,2",
              "--batches", "1", "--sweep-platforms", "GH200",
              "--out-dir", str(out)])
    assert "inflection[GH200]: tp=1 -> " in capsys.readouterr().out
    tp = json.loads((out / "tp_sweep.json").read_text())
    assert [p["tp"] for p in tp["points"]] == [1, 2]


def test_plan_executor_records_a_dispatch_span_per_segment():
    from repro_torch.core.tracing import trace_fn
    from repro_torch.runtime import LaunchPlan, PlanExecutor

    def f(x, w):
        return torch.nn.functional.gelu(x @ w) * 2

    g = torch.Generator().manual_seed(0)
    args = (torch.randn(4, 8, generator=g), torch.randn(8, 8, generator=g))
    tr = trace_fn(f, *args)
    rec = SpanRecorder()
    ex = PlanExecutor(tr, LaunchPlan.chain(tr.kernel_names, 2),
                      recorder=rec)
    out, host = ex.run(*args)
    assert torch.allclose(out[0], f(*args))
    assert len(rec.spans) == ex.n_launches == len(host) > 1
    assert all(s.cat == "dispatch" and s.tid == 1 for s in rec.spans)
    assert [s.args["segment"] for s in rec.spans] == list(range(len(host)))
    assert [s.dur for s in rec.spans] == pytest.approx(host)
    assert rec.spans[0].args["ops"] == ex.segment_operators()[0]
    rec.enabled = False
    ex.run(*args)
    assert len(rec.spans) == ex.n_launches


def test_unported_sweeps_name_their_roadmap_items(setup):
    """``tp_sweep`` is ported (modeled: it prices the traced step per tp,
    ``test_torch_tp_sweep.py``), and so is serving at tp > 1: an engine at
    tp=2 moves, a decode step, the all-reduce bytes the sweep prices at
    the same batch."""
    _, cfg, _, params = setup
    sweep = char.tp_sweep(cfg, params, batches=(1,), tps=(1, 2),
                          platforms=("Intel+H100",), max_len=32,
                          device="cpu")
    assert [p["tp"] for p in sweep["points"]] == [1, 2]
    with ServeEngine(cfg, params, max_batch=1, max_len=32, device="cpu",
                     tp=2) as eng:
        eng.run([Request(0, prompt=[1, 2, 3], max_new_tokens=3)])
        st = eng.stats
    assert st.decode_steps == 2
    assert st.collective_bytes_per_decode_step == \
        sweep["points"][1]["collective_bytes"] > 0
