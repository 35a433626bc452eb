"""The port's metrics registry and serve exports against the reference's.

* The same sequence of registry calls on the port's ``MetricsRegistry``
  and the reference's gives byte-identical ``to_prometheus()`` text and
  equal snapshots, ``get``/``names``, ``count``/``sum``/``quantile``:
  label escaping, ``merge_series``, ``Gauge.add`` (the sequences of
  ``tests/test_observability.py`` and ``tests/test_tracing.py``);
* ``json_sanitize`` gives the reference's strict-JSON payloads;
* ``launch.serve --metrics-out`` writes Prometheus text that parses back
  to the report's counters (``.prom``) or the registry snapshot (any other
  name) carrying the goodput families; ``--attribution`` is refused under
  ``--plan jit`` with the reference's error and, under a launch plan,
  accounts for every dispatch of the decode step.
"""
import contextlib
import io
import json
import math

import pytest
import torch

from repro.core.fusion import json_sanitize as jx_json_sanitize
from repro.telemetry.registry import MetricsRegistry as JxRegistry
from repro_torch.core.fusion import json_sanitize
from repro_torch.launch import serve
from repro_torch.telemetry.registry import MetricsRegistry

torch.set_num_threads(2)


def _basics(reg):
    c = reg.counter("reqs_total", "requests served")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("util", "pool utilization")
    g.set(0.25)
    g.add(0.5)
    g.add(-0.125)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    return [c.value(), g.value(), h.count(), h.sum(), h.quantile(0.25),
            h.quantile(0.5), h.quantile(1.0), h.quantile(0.0)]


def _exposition(reg):
    reg.counter("a_total", "help a").inc(2)
    reg.gauge("b", labels=("batch",)).set(1.5, batch=4)
    reg.histogram("c_seconds", buckets=(0.5, 1.0)).observe(0.7)
    reg.gauge("d").set(float("inf"))
    reg.gauge("e").set(-float("inf"))
    reg.gauge("f").set(1e-9)
    reg.histogram("g_seconds")          # default time buckets, no series
    return [reg.get("b").value(batch=4), reg.get("missing")]


def _labels(reg):
    c = reg.counter("bytes_total", labels=("direction",))
    c.inc(10, direction="evict")
    c.inc(4, direction="restore")
    g = reg.gauge("level", labels=("replica", "state"))
    g.set(3, replica=1, state="serving")
    g.add(2, replica=1, state="serving")
    g.add(-1, replica=0, state="draining")
    return [c.value(direction="evict"), g.value(replica=0, state="draining")]


def _escaped(reg):
    c = reg.counter("ops_total", labels=("op",))
    c.inc(1, op='matmul"fused"')
    c.inc(2, op="a\\b")
    c.inc(3, op="line1\nline2")
    h = reg.histogram("t_seconds", labels=("op",), buckets=(1.0,))
    h.observe(0.5, op='q"x')
    h.observe(2.0, op="a\\b\n")
    return [h.count(op='q"x'), h.quantile(0.99, op="a\\b\n")]


def _merge(reg):
    src = type(reg)()
    h = src.histogram("w_seconds", buckets=(0.1, 1.0), labels=("r",))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, r=0)
    h.observe(0.2, r=1)
    snap = src.snapshot()["w_seconds"]
    h2 = reg.histogram("w_seconds", buckets=tuple(snap["buckets"]),
                       labels=("r",))
    for s in snap["series"]:
        for _ in range(2):
            h2.merge_series(s["value"]["count"], s["value"]["sum"],
                            s["value"]["buckets"], **s["labels"])
    with pytest.raises(ValueError, match="buckets"):
        h2.merge_series(1, 1.0, [1, 2], r=0)
    return [h2.count(r=0), h2.sum(r=0), h2.count(r=1), h2.quantile(0.5, r=0),
            h2.quantile(1.0, r=0), h2.quantile(0.5, r=9)]


def _fleet_like(reg):
    """The fleet aggregation's families: per-replica gauges and the
    router's queue-wait histogram, merged from another registry."""
    src = type(reg)()
    wait = src.histogram("router_queue_wait_seconds", "arrival to dispatch",
                         labels=("replica",))
    for i, v in enumerate((1e-5, 3e-4, 2e-2, 0.7, 12.0, 100.0)):
        wait.observe(v, replica=i % 2)
    src.counter("router_dispatches_total", labels=("replica", "policy")).inc(
        3, replica=0, policy="least-queue-depth")
    for name, fam in src.snapshot().items():
        if fam["type"] == "histogram":
            f = reg.histogram(name, fam["help"],
                              labels=tuple(fam["label_names"]),
                              buckets=tuple(fam["buckets"]))
            for s in fam["series"]:
                v = s["value"]
                f.merge_series(v["count"], v["sum"], v["buckets"],
                               **s["labels"])
        else:
            f = reg.counter(name, fam["help"],
                            labels=tuple(fam["label_names"]))
            for s in fam["series"]:
                f.inc(s["value"], **s["labels"])
    g = reg.gauge("fleet_engine_tokens_out", "tokens", labels=("replica",))
    for r in range(3):
        g.set(10 * r + 0.5, replica=r)
    return [reg.get("router_queue_wait_seconds").quantile(0.5, replica=0),
            reg.get("router_queue_wait_seconds").count(replica=1)]


SEQUENCES = {"basics": _basics, "exposition": _exposition,
             "labels": _labels, "escaped": _escaped, "merge": _merge,
             "fleet_like": _fleet_like}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_prometheus_text_matches_the_reference(name):
    """Byte-identical exposition text, equal snapshots, names and the
    values the sequence reads back."""
    seq = SEQUENCES[name]
    jreg, reg = JxRegistry(), MetricsRegistry()
    jvals, vals = seq(jreg), seq(reg)
    assert vals == jvals
    text = reg.to_prometheus()
    assert text == jreg.to_prometheus()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.names() == jreg.names()
    for n in reg.names():
        assert reg.get(n).kind == jreg.get(n).kind
    # no raw newline survives inside a sample line: each parses back
    assert len(_parse_prom(text)) == sum(
        1 for line in text.splitlines() if not line.startswith("#"))


def test_quantile_and_label_errors_match_the_reference():
    for cls in (JxRegistry, MetricsRegistry):
        reg = cls()
        h = reg.histogram("h", buckets=(1.0,))
        with pytest.raises(ValueError, match="q must be"):
            h.quantile(1.5)
        assert h.quantile(0.5) == 0.0 and h.count() == 0 and h.sum() == 0.0
        h.observe(3.0)
        assert h.quantile(0.5) == math.inf
        g = reg.gauge("g", labels=("a",))
        with pytest.raises(ValueError, match="declared labels"):
            g.add(1.0)
        with pytest.raises(TypeError, match="already registered"):
            reg.counter("g")
        assert reg.get("nope") is None


def test_json_sanitize_matches_the_reference():
    payload = {"a": [1.0, float("inf"), {"b": float("nan")}],
               "c": (float("-inf"), 2), "d": "x", "e": None, "f": 3}
    out = json_sanitize(payload)
    assert json.dumps(out, allow_nan=False) == json.dumps(
        jx_json_sanitize(payload), allow_nan=False)
    assert out["a"][1] == "inf" and out["c"] == ["-inf", 2]


def _parse_prom(text: str) -> dict:
    """Sample lines of Prometheus text -> {(name, labels): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, val = line.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        out[(name, labels.rstrip("}"))] = float(val)
    return out


def _serve(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng, done = serve.main(["--reduced", "--device", "cpu", "--requests",
                                "3", "--max-batch", "2", "--max-new", "4",
                                "--max-len", "32", *argv])
    return eng, done, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_serve_metrics_out_prometheus_parses_back(tmp_path):
    path = str(tmp_path / "m.prom")
    eng, done, rep = _serve("--metrics-out", path, "--slo-ttft-ms", "1e-6",
                            "--slo-itl-ms", "1e6")
    assert rep["metrics_out"] == path
    with open(path) as fh:
        text = fh.read()
    assert text == eng.registry.to_prometheus()
    samples = _parse_prom(text)
    for field, fam in (("tokens_out", "engine_tokens_out"),
                       ("decode_steps", "engine_decode_steps"),
                       ("prefills", "engine_prefills"),
                       ("decode_dispatches", "engine_decode_dispatches")):
        assert samples[(fam, "")] == rep[field], field
    # goodput recorded before the export: every request misses the TTFT
    assert samples[("goodput_ratio", "")] == 0.0
    assert samples[("goodput_requests_total", 'verdict="ttft"')] == 3
    assert samples[("slo_ttft_seconds", "")] == pytest.approx(1e-9)
    assert rep["triage"]["conservation"]["ok"]
    assert rep["triage"]["slo_report"]["verdicts"]["ttft"] == 3
    assert samples[("engine_ttft_seconds_count", "")] == 3


def test_serve_metrics_out_json_is_the_snapshot(tmp_path):
    path = str(tmp_path / "m.json")
    eng, done, rep = _serve("--metrics-out", path)
    with open(path) as fh:
        snap = json.load(fh)
    assert snap == json.loads(json.dumps(json_sanitize(
        eng.registry.snapshot())))
    assert snap["engine_tokens_out"]["series"][0]["value"] == \
        rep["tokens_out"]
    # no SLO set: no goodput families, triage without an SLO report
    assert "goodput_ratio" not in snap and "slo_report" not in rep["triage"]


def test_serve_attribution_needs_a_launch_plan(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--attribution"])
    assert "--attribution needs a launch-plan mode" in capsys.readouterr().err


def test_serve_attribution_accounts_every_decode_dispatch():
    eng, done, rep = _serve("--plan", "fused", "--attribution")
    att = rep["attribution"]
    assert att["complete"]
    assert att["accounted_launches"] == att["total_events"]
    # one decode step's attribution: its launches are the step's dispatches
    assert att["accounted_launches"] == rep["dispatches_per_decode_step"]
    assert att["rows"] and {r["operator"] for r in att["rows"]}
    assert rep["boundedness"] is not None
    assert rep["rule_hits"]
