"""The port's examples (``repro_torch.examples``) on the CPU, against the
reference's scripts in ``examples/``.

Each ``main(device="cpu")`` runs and returns the numbers it prints.  The
serving example builds its requests as the reference script does and
serves as many tokens in as many decode steps as the reference's
``ServeEngine`` built the same way (the weights differ: each side draws
its own).  The training example resumes at the step-20 checkpoint,
finishes at step 40 and gives an uninterrupted run's losses exactly.  The
platform example keeps the paper's two claims (GH200 slower at batch 1,
faster at batch 256); its crossover on the batch grid is 16 where the
reference's is 4: the aten stream of the same forward carries the same
FLOPs in 260 kernels and half the modeled bytes of the reference's 474
jaxpr equations (an aten op such as GELU or a norm reads and writes once
where the jaxpr has one equation a step), so the modeled device work
overtakes GH200's host cost a little later, at batch 5 on a grid of every
batch (the reference: 4), and the grid's next point is 16.  The
reference's quickstart is not run here (40 s on this CPU).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.core import SKIP as JxSKIP
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro_torch.examples import (platform_characterization, quickstart,
                                  serve_continuous_batching,
                                  train_fault_tolerant)
from repro_torch.training.loop import TrainConfig, Trainer

torch.set_num_threads(2)


def test_quickstart_runs_and_fuses():
    out = quickstart.main(device="cpu")
    assert out["kernels"] > 0
    assert set(out["platforms"]) == {"Intel+H100", "AMD+A100", "GH200"}
    # GH200's slower host makes every launch dearer
    assert out["platforms"]["GH200"]["tklqt_s"] > \
        out["platforms"]["Intel+H100"]["tklqt_s"] > 0
    assert out["deterministic_chains"] > 0 and out["ideal_speedup"] > 1
    fuse = out["fuse"]
    assert fuse["k_fused"] < fuse["k_eager"] == out["kernels"]
    assert fuse["max_abs_err"] <= 2e-5


def test_serving_example_matches_the_reference_engine():
    """The request set, tokens out and decode steps of the reference
    script's engine, built as the script builds it."""
    out = serve_continuous_batching.main(device="cpu")
    jcfg = jx_reduced(jx_get_config("smollm-360m"), n_layers=4, d_model=128,
                      d_ff=256)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jreqs = [JxRequest(i, prompt=list(rng.integers(0, jcfg.vocab_size,
                                                   int(rng.integers(4, 24)))),
                       max_new_tokens=int(rng.integers(4, 20)))
             for i in range(12)]
    reqs = serve_continuous_batching.requests(jcfg.vocab_size)
    assert [(r.rid, [int(t) for t in r.prompt], r.max_new_tokens)
            for r in reqs] == \
        [(r.rid, [int(t) for t in r.prompt], r.max_new_tokens)
         for r in jreqs]
    jeng = JxServeEngine(jcfg, jparams, max_batch=4, max_len=128)
    jdone = jeng.run(jreqs)
    assert out["requests"] == len(jdone) == 12
    assert out["tokens_out"] == jeng.stats.tokens_out
    assert out["decode_steps"] == jeng.stats.decode_steps == 38
    assert out["mean_slot_occupancy"] == pytest.approx(
        float(np.mean(jeng.stats.slot_occupancy)))
    assert sorted(out["generated"]) == sorted(r.rid for r in jdone)
    assert {rid: len(g) for rid, g in out["generated"].items()} == \
        {r.rid: len(r.generated) for r in jdone}


def test_platform_example_keeps_the_papers_claims():
    out = platform_characterization.main(device="cpu")
    assert out["gh200_penalty_b1"] > 1 and out["gh200_speedup_b256"] > 1
    # the reference's crossover on the same batches, from its own trace
    jcfg = jx_get_config("gpt2").replace(n_layers=4, param_dtype="float32",
                                         compute_dtype="float32")
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, 512), 0,
                              jcfg.vocab_size)
    skip = JxSKIP.trace(lambda p, t: jx_forward(p, t, jcfg, unroll=True)[0],
                        jparams, toks)

    def crossover(il):
        return next((b for i, b in enumerate(out["batches"])
                     if il["GH200"][i] < min(il["Intel+H100"][i],
                                             il["AMD+A100"][i])), None)
    ref = {plat: [skip.report(plat, b, use_host_scale=False).il
                  for b in out["batches"]] for plat in out["il_s"]}
    assert crossover(ref) == 4
    assert out["crossover_batch"] == crossover(out["il_s"]) == 16
    # the same FLOPs in fewer kernels and bytes (see the module docstring)
    assert out["kernels"] < len(skip.trace_.kernels)
    assert out["fusion_ideal_speedup_l32"] >= 1


def test_training_example_resumes_exactly(tmp_path):
    out = train_fault_tolerant.main(device="cpu",
                                    ckpt_dir=str(tmp_path / "example"))
    assert out["crash"] == "simulated failure at 20"
    assert out["resumed_at"] == 20 and out["final_step"] == 40
    cfg, data = train_fault_tolerant.config()
    whole = Trainer(cfg, data, TrainConfig(steps=40, ckpt_every=40,
                                           ckpt_dir=str(tmp_path / "whole")),
                    device="cpu").run()
    assert out["losses"] == [h["loss"] for h in whole["history"][20:]]
