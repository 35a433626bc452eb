"""The train step bundle on rank processes against the reference, for the
MoE stacks: reduced Moonlight (expert-parallel MoE beside head-parallel
attention, ``microbatches`` 1 and 2) and Jamba (Mamba's d_inner split,
MoE, attention) on a (data 2, model 2) mesh.  What is compared, and the
reference's per-shard function for a MoE stack: ``test_torch_steps_train.py``
and ``_torch_steps.py``."""
import multiprocessing

import pytest

import _torch_steps as st
from repro_torch.distributed.ranks import RankPool

# (arch, S, microbatches, (pod, data, model))
CASES = [
    ("moonshot-v1-16b-a3b", 9, 1, (0, 2, 2)),
    ("moonshot-v1-16b-a3b", 9, 2, (0, 2, 2)),
    ("jamba-1.5-large-398b", 9, 1, (0, 2, 2)),
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
