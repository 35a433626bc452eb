"""The train step bundle on rank processes against the reference, for
RWKV-6: reduced ``rwkv6-3b`` (the time mix's heads and the channel mix's
d_ff split, its recurrence through the ``wkv6`` backward) on a (data 2,
model 2) mesh, ``microbatches`` 1 and 2.  What is compared:
``test_torch_steps_train.py`` and ``_torch_steps.py``."""
import multiprocessing

import pytest

import _torch_steps as st
from repro_torch.distributed.ranks import RankPool

# (arch, S, microbatches, (pod, data, model))
CASES = [
    ("rwkv6-3b", 8, 1, (0, 2, 2)),
    ("rwkv6-3b", 8, 2, (0, 2, 2)),
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
