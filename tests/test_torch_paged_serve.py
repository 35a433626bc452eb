"""The port's paged serving engine against the reference's, on reduced SmolLM.

Reduced SmolLM (2 layers, f32) with the reference's weights bridged bit
for bit.  For each paged configuration the same requests go through
``repro.inference.engine.ServeEngine(cache="paged", plan="jit",
platform="Intel+H100")`` and the port's engine on the CPU: greedy tokens
byte-identical, the scheduling and offload counters equal, and the modeled
offload tax within 1e-12 s.  Also: the CLI's paged flags and report, and
the options that stay unported on the paged path.
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
COUNTERS = ("prefills", "decode_steps", "tokens_out", "prefill_chunks",
            "preemptions", "offload_bytes", "restore_bytes",
            "offload_transfers", "prefix_adoptions", "shared_prefix_tokens")


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _requests(cls, vocab, shared_prefix=False):
    """Four prompts of 7, 10, 13 and 16 tokens, five new tokens each (the
    reference's paged engine tests); with ``shared_prefix`` every prompt
    starts with the same 12 tokens and the first request decodes longer,
    so its blocks are still live when the later ones are admitted."""
    rng = np.random.default_rng(0)
    head = [int(t) for t in rng.integers(0, vocab, 12)]
    reqs = []
    for i in range(4):
        prompt = [int(t) for t in rng.integers(0, vocab, 7 + 3 * i)]
        if shared_prefix:
            prompt = head + prompt[:1 + i]
        budget = 12 if shared_prefix and i == 0 else 5
        reqs.append(cls(i, prompt=prompt, max_new_tokens=budget))
    return reqs


CASES = {
    "plain": dict(block_size=8),
    "chunked": dict(block_size=8, prefill_chunk=4),
    "preempt_recompute": dict(block_size=4, num_blocks=6),
    "preempt_offload": dict(block_size=4, num_blocks=6, offload="host"),
    "share_prefix": dict(block_size=4, share_prefix=True),
    "int8": dict(block_size=8, kv_dtype="int8"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_engine_matches_the_reference(setup, case):
    jcfg, cfg, jparams, params = setup
    kw = dict(max_batch=2, max_len=32, cache="paged", **CASES[case])
    shared = case == "share_prefix"
    jeng = JxServeEngine(jcfg, jparams, plan="jit", platform="Intel+H100",
                         **kw)
    jdone = jeng.run(_requests(JxRequest, cfg.vocab_size, shared))
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    done = eng.run(_requests(Request, cfg.vocab_size, shared))
    assert [(r.rid, r.status, r.generated) for r in done] == \
        [(r.rid, r.status, r.generated) for r in jdone]
    assert all(r.status == "done" for r in done)
    js, st = jeng.stats, eng.stats
    for name in COUNTERS:
        assert getattr(st, name) == getattr(js, name), name
    assert abs(st.modeled_offload_tax_s - js.modeled_offload_tax_s) <= 1e-12
    assert st.slot_occupancy == js.slot_occupancy
    assert st.block_pool_utilization == js.block_pool_utilization
    assert eng.kv.num_blocks == jeng.kv.num_blocks
    assert eng.kv.pool.cow_copies_total == jeng.kv.pool.cow_copies_total
    if case.startswith("preempt"):
        assert st.preemptions > 0
    if case == "preempt_offload":
        assert st.offload_bytes == st.restore_bytes > 0
    if case == "share_prefix":
        assert st.prefix_adoptions > 0
    if case == "chunked":
        assert st.prefill_chunks > st.prefills
    # reset keeps the engine; the same workload gives the same tokens
    eng.reset()
    assert eng.kv.pool.used_blocks == 0 and eng.stats.preemptions == 0
    again = eng.run(_requests(Request, cfg.vocab_size, shared))
    assert [r.generated for r in again] == [r.generated for r in done]


def test_pool_too_small_raises(setup):
    _, cfg, _, params = setup
    eng = ServeEngine(cfg, params, max_batch=1, max_len=32, cache="paged",
                      block_size=4, num_blocks=2, device="cpu")
    rng = np.random.default_rng(0)
    req = Request(0, prompt=[int(t) for t in rng.integers(0, 50, 12)],
                  max_new_tokens=8)
    with pytest.raises(RuntimeError, match="pool"):
        eng.run([req])


@pytest.mark.parametrize("kw,match", [
    (dict(cache="virtual"), "cache"), (dict(offload="host"), "paged"),
    (dict(cache="paged", offload="disk"), "offload"),
    (dict(cache="paged", prefill_chunk=0), "prefill_chunk"),
    (dict(prefill_chunk=8), "paged"), (dict(kv_dtype="int8"), "paged"),
    (dict(cache="paged", kv_dtype="fp8"), "kv_dtype"),
    (dict(cache="paged", platform="A100-PCIe"), "platform")])
def test_engine_rejects_bad_paged_config(setup, kw, match):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, params, max_batch=2, max_len=32, device="cpu", **kw)


def test_paged_engine_defaults_to_the_gpu(setup):
    _, cfg, _, params = setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, cache="paged")


def test_serve_cli_paged_report():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng, done = serve.main([
            "--reduced", "--device", "cpu", "--requests", "4",
            "--max-batch", "2", "--max-new", "6", "--cache", "paged",
            "--kv-dtype", "int8", "--block-size", "4", "--num-blocks", "6",
            "--prefill-chunk", "4", "--offload", "host"])
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rep["requests"] == 4 and rep["tokens_out"] == 24
    assert rep["cache"] == "paged" and rep["kv_dtype"] == "int8"
    assert rep["num_blocks"] == 6 and rep["platform"] == "Intel+H100"
    assert rep["preemptions"] > 0 and rep["prefill_chunks"] >= 12
    assert rep["offload_bytes"] == rep["restore_bytes"] > 0
    assert rep["modeled_offload_tax_us"] > 0
    assert rep["measured_offload_copy_us"] is None      # CPU: not measured
    assert 0 < rep["block_pool_utilization"]["peak"] <= 1
    assert rep["decode_steps"] == eng.stats.decode_steps
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            serve.main(["--reduced", "--device", "cpu", "--kv-dtype",
                        "int8"])
