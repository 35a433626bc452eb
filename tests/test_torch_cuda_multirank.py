"""The multi-rank training pieces on the card, at 1-2 layers: two rank
processes share one GPU over gloo (``distributed.ranks``), running
``chip_smoke.py``'s own phase-22 rank bodies and gates at fewer layers.

Marked ``cuda``: each test skips without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \\
        tests/test_torch_cuda_multirank.py

* (a) SmolLM-360M at full width, 2 of its 32 layers, bf16, data parallel
  over 2 ranks with the int8 compressed gradients and AdamW: the first
  step's mean within 0.05 relative of the exact mean, the parameters
  bit-identical across the ranks after every step, the loss falling, and
  each rank's forward launching the three kernels;
* (b) Moonlight-16B-A3B at full width, 1 layer, f32 (TF32 off), expert
  parallel at ep 2 (``seq`` and ``rep``, capacity factor 8) against the
  local path: logits and the gradients of ``loss_fn(aux_weight=0)``
  within 1e-4 relative (phase 22 (b)'s f32 gate);
* (c) SmolLM-360M cut to 2 blocks in 2 pipeline stages, bf16: the GPipe
  output equal to ``reference_forward``'s on one rank.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.distributed.ranks import RankPool
from repro_torch.launch.mesh import Mesh, make_host_mesh

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke`` (it needs a GPU at import); the ranks import it by
    reference to run its bodies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def pool(cs):
    with RankPool(2, "cuda", timeout_s=600) as p:
        yield p


def test_compressed_data_parallel_training(cs, pool):
    steps = cs.MR_STEPS
    outs = pool.run(cs.mr_dp_train, make_host_mesh(data=2, device="cuda"),
                    [(steps, 2)] * 2)
    a, b = outs
    assert a["checksums"] == b["checksums"]
    assert max(o["first_rel"] for o in outs) <= cs.COMPRESS_TOL
    assert a["losses"][-1] < a["losses"][0]
    for o in outs:
        assert o["launches"]["flash_attention"] == 2 * steps
        assert o["launches"]["rmsnorm_matmul"] == 2 * steps
        assert o["launches"]["residual_rmsnorm"] == 3 * steps


@pytest.mark.parametrize("mode", ["seq", "rep"])
def test_expert_parallel_matches_the_local_path(cs, pool, mode):
    outs = pool.run(cs.mr_ep_check, make_host_mesh(model=2, device="cuda"),
                    [("float32", 1, cs.EP_CF, (mode,), True)] * 2)
    row = cs.ep_row(outs, mode)
    ok, tol = cs.ep_gate(row, "float32")
    assert ok, (row, tol)


def test_pipeline_matches_the_sequential_run(cs, pool):
    mesh = Mesh({"pipe": 2}, (torch.device("cuda", 0),) * 2)
    out = pool.run(cs.mr_pipeline, mesh, [(4, 2, 2)] * 2)[0]
    assert out["finite"] and out["equal"], out
