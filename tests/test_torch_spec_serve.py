"""Speculative serving under pool pressure, and ``spec_sweep``, against the
reference on the CPU.

Reduced SmolLM-360M (2 layers, f32, the reference's weights bridged bit for
bit) with the reference's adversarial draft (an untied, shifted unembed
the target rejects nearly every round):

  * a tight paged pool with host offload: speculation's over-grown verify
    windows force the block-table rollback and interact with evict and
    restore (the draft's cache rebuilt at resume); the tokens equal the
    JAX engine's plain greedy ones, and preemptions, offload bytes and
    the speculative counters equal the JAX speculative engine's;
  * the rollback returns the blocks grown for rejected positions: the
    peak pool utilization stays within one verify window of plain
    decoding's and equals the JAX speculative engine's;
  * ``spec_sweep``: the measured rows equal the reference's, and the
    modeled rows price the port's own traced decode stream;
  * ``launch.characterize --spec-sweep`` writes ``spec_sweep.json``.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.inference import speculative as jx_spec
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import init_params as jx_init_params
import repro.telemetry.characterize as jx_char
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.speculative import (default_draft_config,
                                               draft_params_from_target)
from repro_torch.launch import characterize as cli
import repro_torch.telemetry.characterize as char

torch.set_num_threads(2)
COUNTERS = ("spec_rounds", "proposed", "accepted", "corrections",
            "draft_dispatches", "tokens_out", "decode_steps", "preemptions",
            "offload_bytes", "restore_bytes")


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config("smollm-360m"), n_layers=2)
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    jdcfg = jx_spec.default_draft_config(jcfg).replace(tie_embeddings=False)
    jdparams = dict(jx_spec.draft_params_from_target(jparams, jdcfg))
    jdparams["lm_head"] = jnp.roll(jparams["embed"], 1, axis=0).T
    dcfg = default_draft_config(cfg).replace(tie_embeddings=False)
    dparams = dict(draft_params_from_target(params, dcfg))
    dparams["lm_head"] = torch.roll(params["embed"], 1, 0).T.contiguous()
    return (jcfg, jparams, jdcfg, jdparams), (cfg, params, dcfg, dparams)


def _requests(cls, vocab, n, new, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(i, prompt=[int(t) for t in rng.integers(1, vocab, 5 + i)],
                max_new_tokens=new) for i in range(n)]


def _run(eng, cls, vocab, n, new):
    done = eng.run(_requests(cls, vocab, n, new))
    return {r.rid: list(r.generated) for r in done}


def _pair(setup, kw, n, new):
    """(JAX plain tokens, JAX speculative engine and tokens, port
    speculative engine and tokens) under the engine options ``kw``."""
    (jcfg, jparams, jdcfg, jdparams), (cfg, params, dcfg, dparams) = setup
    plain = _run(JxServeEngine(jcfg, jparams, **kw), JxRequest,
                 jcfg.vocab_size, n, new)
    jeng = JxServeEngine(jcfg, jparams, speculative=True, spec_k=4,
                         draft_config=jdcfg, draft_params=jdparams, **kw)
    jtoks = _run(jeng, JxRequest, jcfg.vocab_size, n, new)
    eng = ServeEngine(cfg, params, speculative=True, spec_k=4,
                      draft_config=dcfg, draft_params=dparams, device="cpu",
                      **kw)
    toks = _run(eng, Request, cfg.vocab_size, n, new)
    return plain, (jeng, jtoks), (eng, toks)


def test_spec_preempt_resume_matches_the_reference(setup):
    """Tight pool + host offload: rollback, eviction and restore together;
    the tokens must not change."""
    kw = dict(max_batch=4, max_len=64, cache="paged", block_size=4,
              num_blocks=24, offload="host")
    plain, (jeng, jtoks), (eng, toks) = _pair(setup, kw, n=4, new=14)
    assert toks == plain == jtoks
    assert {c: getattr(eng.stats, c) for c in COUNTERS} == {
        c: getattr(jeng.stats, c) for c in COUNTERS}
    assert eng.stats.preemptions > 0 and eng.stats.restore_bytes > 0
    assert eng.stats.accept_rate < 0.5


def test_spec_round_trims_rejected_blocks(setup):
    """Each verify window grows the table past what the one emitted token
    needs; the rollback returns those blocks, so the peak utilization
    stays within one verify window of plain decoding's (k = 4 touches at
    most 3 blocks a row past the emitted length)."""
    (_, _, _, _), (cfg, params, _, _) = setup
    kw = dict(max_batch=2, max_len=64, cache="paged", block_size=4,
              num_blocks=32)
    ref = ServeEngine(cfg, params, device="cpu", **kw)
    _run(ref, Request, cfg.vocab_size, 2, 10)
    plain, (jeng, jtoks), (eng, toks) = _pair(setup, kw, n=2, new=10)
    assert toks == plain == jtoks
    assert eng.stats.accept_rate < 0.5
    slack = 3 * kw["max_batch"] / kw["num_blocks"]
    assert (eng.stats.peak_block_pool_utilization
            <= ref.stats.peak_block_pool_utilization + slack)
    assert (eng.stats.block_pool_utilization
            == pytest.approx(jeng.stats.block_pool_utilization))
    assert eng.kv.pool.free_blocks == kw["num_blocks"]


# closed loop (code-completion): the schedule does not depend on measured
# times, so both engines take the same steps
SWEEP = dict(scenario="code-completion", ks=(0, 3), batches=(1, 2),
             n_requests=3, prompt_cap=8, output_cap=6, max_len=32,
             model_batches=(1, 2, 16), platforms=("Intel+H100", "GH200"))


def test_spec_sweep_matches_the_reference(setup):
    (jcfg, jparams, _, _), (cfg, params, _, _) = setup
    want = jx_char.spec_sweep(jcfg, jparams, **SWEEP)
    got = char.spec_sweep(cfg, params, device="cpu", **SWEEP)
    assert got["measured"] == want["measured"]
    for key in ("arch", "draft", "scenario", "seed", "n_requests", "ks",
                "batches", "model_batches", "platforms"):
        assert got[key] == want[key], key
    assert got["device"] == "cpu"
    # the modeled side prices the port's own stream, row for row
    assert [(r["platform"], r["k"], r["batch"], r["measured"],
             r["accept_rate"], r["emitted_per_seq_per_round"])
            for r in got["modeled"]] == [
        (r["platform"], r["k"], r["batch"], r["measured"],
         r["accept_rate"], r["emitted_per_seq_per_round"])
        for r in want["modeled"]]
    assert got["n_draft_kernels"] > 0
    for r in got["modeled"]:
        assert r["modeled_spec_per_token_us"] > 0
        assert r["modeled_draft_launch_tax_per_round_us"] > 0


def test_characterize_cli_spec_sweep(tmp_path):
    out = tmp_path / "out"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sweep = cli.main(["--reduced", "--device", "cpu", "--spec-sweep",
                          "--scenario", "code-completion",
                          "--spec-ks", "0,2", "--batches", "1",
                          "--model-batches", "4", "--requests", "2",
                          "--prompt-cap", "6", "--output-cap", "4",
                          "--max-len", "32", "--out-dir", str(out)])
    text = buf.getvalue()
    assert "measured k=2  batch=1" in text and "win_batches[GH200]" in text
    assert json.loads((out / "spec_sweep.json").read_text()) == json.loads(
        json.dumps(sweep))
    assert sweep["model_batches"] == [1, 4]
    assert json.loads(text.strip().splitlines()[-1])["artifacts"] == {
        "sweep": str(out / "spec_sweep.json")}
