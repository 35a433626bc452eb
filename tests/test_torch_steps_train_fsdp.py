"""The train step bundle on rank processes against the reference with the
experts under FSDP: reduced Moonlight on a (data 2, model 2) mesh with
``FSDP_THRESHOLD_BYTES`` lowered to 0, so that ``needs_fsdp`` splits the
expert leaves over the data axis as well (the layout production Kimi K2
trains in), with AdamW and with Adafactor (the factored statistics of a
data-split leaf averaged over its slices).  The loss, the gradient norm
and every new parameter agree with the reference's within 1e-5: what is
compared and why, ``test_torch_steps_train.py``."""
import multiprocessing

import pytest

import _torch_steps as st
from repro_torch.distributed.ranks import RankPool
from repro_torch.distributed.sharding import _at, _tree_map
from repro_torch.launch import steps

# (arch, S, microbatches, (pod, data, model), optimizer)
CASES = [
    ("moonshot-v1-16b-a3b", 9, 1, (0, 2, 2), "adamw"),
    ("moonshot-v1-16b-a3b", 9, 1, (0, 2, 2), "adafactor"),
]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.mark.parametrize("case", CASES, ids=st.case_id)
def test_fsdp_train_step_matches_the_reference(pool, case, monkeypatch):
    monkeypatch.setattr(steps, "FSDP_THRESHOLD_BYTES", 0)
    bundle = st.run_case(pool, case)
    assert bundle.plan.fsdp
    specs = []
    _tree_map(lambda path, _: specs.append(
        (path, _at(bundle.plan.specs[0], path))), bundle.in_specs[0])
    experts = [spec for path, spec in specs
               if "moe" in path and path[-1] in ("w_in", "w_gate", "w_out")]
    assert experts and all("data" in spec for spec in experts), experts


def test_zz_the_pool_closes(pool):
    """Last in the module: the ranks end with the pool."""
    pool.close()
    assert not multiprocessing.active_children()
