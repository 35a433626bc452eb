"""The train step bundle (``launch.steps.build_train_step``) on gloo rank
processes on the CPU, against the reference's single-device
``value_and_grad(loss_fn)`` and ``opt_update``, in f32.

Reduced configs, a global batch of 4.  Here InternLM2-20B (attention
heads, d_ff and the vocabulary split, ``seq_shard``) on a (data 2, model
2) mesh with ``microbatches`` 1 and 2, on (pod 2, data 1, model 2), and
with Adafactor (its factored statistics and its update's RMS taken over
every rank's slice of a leaf); the MoE stacks in
``test_torch_steps_train_moe.py``, RWKV-6 in
``test_torch_steps_train_rwkv.py``.  The vocabulary is 512 on both
sides, so that it splits over the model axis.

The reference's step cannot be lowered under this JAX (ROADMAP Queue C),
so its function is computed on one device: for a dense stack its
``loss_fn`` over the global batch; for a MoE stack, whose aux loss and
capacity are per shard in the reference's ``forward(dist=)`` as in the
port's, the mean of its ``loss_fn`` over each rank's rows (S = 9 does not
divide by the model axis: the experts run replicated over it, "rep") and
each microbatch, which is the loss the ranks compute.  Then ``opt_update``
with AdamW at lr 1e-3, no warm-up and eps 1e-4 on both sides, so that the
step moves the weights by about 1e-3 and each element's update is a
smooth function of its gradient (at AdamW's default eps 1e-8 the first
step is the gradient's sign, and an element whose gradient is near 1e-8
turns its f32 rounding into an update error of the step's size).
The loss, the global gradient norm and every new parameter, gathered from
the ranks, agree within 1e-5.  No rank outlives the module.
"""
import multiprocessing

import pytest

import _torch_steps as st
from repro_torch.distributed.ranks import RankPool

# (arch, S, microbatches, (pod, data, model))
CASES = [
    ("internlm2-20b", 8, 1, (0, 2, 2)),
    ("internlm2-20b", 8, 2, (0, 2, 2)),
    ("internlm2-20b", 8, 1, (2, 1, 2)),
    ("internlm2-20b", 8, 1, (0, 2, 2), "adafactor"),
]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.mark.parametrize("case", CASES, ids=st.case_id)
def test_train_step_matches_the_reference(pool, case):
    st.run_case(pool, case)


def test_zz_the_pool_closes(pool):
    """Last in the module: the ranks end with the pool."""
    pool.close()
    assert not multiprocessing.active_children()
