"""The port's workload subsystem against the reference's.

For every scenario and seeds 0-2 the port's ``sample_requests`` gives the
reference's requests field for field (the same ``numpy`` draws in the same
order), both ``save_workload``s write the same bytes, and each package
loads the other's file.  Degenerate scenarios are refused as in the
reference, and a replayed trace from a bigger vocabulary is refused before
any engine serves it (an out-of-range token is an index error in
``torch.embedding`` on the CPU, a device-side assert on CUDA).
"""
import numpy as np
import pytest
import torch

from repro import workload as jx_workload
from repro_torch import workload
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params
from repro_torch.telemetry.characterize import characterize
from repro_torch.workload.scenarios import LengthDist, Scenario

torch.set_num_threads(2)
SCENARIOS = ("agentic", "chatbot", "code-completion", "summarization")


def test_the_scenario_catalogs_are_equal():
    assert workload.list_scenarios() == jx_workload.list_scenarios() \
        == list(SCENARIOS)
    for name in SCENARIOS:
        ours, ref = workload.get_scenario(name), jx_workload.get_scenario(name)
        for f in ("name", "description", "arrival", "rate_rps", "burst_s",
                  "idle_s", "slo_ttft_s", "slo_itl_s"):
            assert getattr(ours, f) == getattr(ref, f), (name, f)
        for dist in ("prompt", "output"):
            a, b = getattr(ours, dist), getattr(ref, dist)
            assert (a.kind, a.lo, a.hi, a.sigma) == (b.kind, b.lo, b.hi,
                                                      b.sigma)
    with pytest.raises(KeyError):
        workload.get_scenario("nope")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sample_requests_equal_the_reference(scenario, seed):
    for kw in (dict(), dict(prompt_cap=16, output_cap=4),
               dict(time_scale=4.0, shared_prefix=5, vocab_size=211)):
        ours = workload.sample_requests(scenario, 17, seed=seed, **kw)
        ref = jx_workload.sample_requests(scenario, 17, seed=seed, **kw)
        assert ours.meta() == ref.meta()
        assert [r.to_json() for r in ours.requests] == \
            [r.to_json() for r in ref.requests]


def test_save_is_byte_identical_and_cross_loads(tmp_path):
    ours = workload.sample_requests("chatbot", 9, seed=5, vocab_size=211)
    ref = jx_workload.sample_requests("chatbot", 9, seed=5, vocab_size=211)
    p_ours, p_ref = str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")
    workload.save_workload(ours, p_ours)
    jx_workload.save_workload(ref, p_ref)
    assert open(p_ours, "rb").read() == open(p_ref, "rb").read()
    a = workload.load_workload(p_ref)           # the port reads the JAX file
    b = jx_workload.load_workload(p_ours)       # and the other way round
    assert a.meta() == b.meta() == ours.meta()
    assert [r.to_json() for r in a.requests] == \
        [r.to_json() for r in b.requests] == \
        [r.to_json() for r in ours.requests]
    p2 = str(tmp_path / "again.jsonl")
    workload.save_workload(a, p2)
    assert open(p2, "rb").read() == open(p_ours, "rb").read()


def test_load_rejects_a_header_mismatch(tmp_path):
    p = str(tmp_path / "bad.jsonl")
    workload.save_workload(workload.sample_requests("chatbot", 3, seed=0), p)
    lines = open(p).read().splitlines()
    open(p, "w").write("\n".join(lines[:-1]) + "\n")  # drop one request
    with pytest.raises(ValueError, match="header claims"):
        workload.load_workload(p)


def test_scenario_rejects_degenerate_params():
    dist = LengthDist("fixed", 4)
    with pytest.raises(ValueError, match="rate_rps"):
        Scenario("x", "", "poisson", dist, dist)          # rate_rps=0
    with pytest.raises(ValueError, match="burst_s"):
        Scenario("x", "", "bursty", dist, dist, rate_rps=1.0)
    with pytest.raises(ValueError, match="idle_s"):
        Scenario("x", "", "bursty", dist, dist, rate_rps=1.0, burst_s=1.0,
                 idle_s=-1.0)
    with pytest.raises(ValueError, match="arrival"):
        Scenario("x", "", "warp", dist, dist)
    with pytest.raises(ValueError, match="time_scale"):
        workload.sample_requests("chatbot", 4, seed=0, time_scale=0.0)
    with pytest.raises(ValueError, match="shared_prefix"):
        workload.sample_requests("chatbot", 4, seed=0, shared_prefix=-1)
    with pytest.raises(ValueError, match="distribution kind"):
        LengthDist("zipf", 4).sample(np.random.default_rng(0))


def test_a_bigger_vocab_replay_raises():
    cfg = reduced(get_config("smollm-360m"))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    wl = workload.sample_requests("chatbot", 2, seed=0,
                                  vocab_size=cfg.vocab_size * 10)
    with pytest.raises(ValueError, match="vocab_size"):
        characterize(cfg, params, batches=(1,), workload=wl, device="cpu")
