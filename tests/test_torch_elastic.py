"""Elastic restore on the CPU: a checkpoint of whole leaves restored as
each rank's shard at another mesh, against the reference's
``shardings_for`` slices.

The reference test's case (``tests/test_distributed.py::
test_elastic_restore_across_mesh_shapes``): reduced ``internlm2-20b``
saved once and restored at meshes (2, 4), (4, 2) and (8, 1).  The
reference runs in a subprocess with 8 forced host devices and prints, for
every leaf and every device of each mesh, the index of that device's
shard of the restored array; device r of the mesh (rank-major) is the
port's rank r.  The port's leaves are the reference's unstacked
(``bridge.params_from_jax``), so a stacked leaf's superblock dimension,
which no spec splits, selects the port's layer.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_multirank as mr
from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.models import init_params as jx_init_params
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.sharding import param_specs, shardings_for
from repro_torch.launch.elastic import elastic_restore
from repro_torch.launch.mesh import axes_index, make_host_mesh, rank_coords
from repro_torch.tree import named_leaves

torch.set_num_threads(2)
ARCH = "internlm2-20b"
MESHES = [(2, 4), (4, 2), (8, 1)]

_JAX = """
import json, tempfile, jax, numpy as np
from repro.checkpoint.manager import CheckpointManager
from repro.configs import get_config, reduced
from repro.distributed.sharding import param_specs, shardings_for
from repro.launch.mesh import make_host_mesh
from repro.models import init_params
cfg = reduced(get_config("internlm2-20b"))
params = init_params(jax.random.PRNGKey(0), cfg)
ckpt = CheckpointManager(tempfile.mkdtemp(), async_write=False)
ckpt.save(1, params)
out = {}
for shape in %r:
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    sh = shardings_for(params, param_specs(params, cfg, mesh), mesh)
    restored = ckpt.restore(1, params, shardings=sh)
    leaves = {}
    for path, arr in jax.tree_util.tree_flatten_with_path(restored)[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        by_dev = {s.device: s.index for s in arr.addressable_shards}
        leaves["/".join(keys)] = [
            [[sl.start or 0, arr.shape[d] if sl.stop is None else sl.stop]
             for d, sl in enumerate(by_dev[dev])]
            for dev in mesh.devices.flat]
    out["%%dx%%d" %% shape] = leaves
print(json.dumps(out))
""" % (MESHES,)


@pytest.fixture(scope="module")
def ref():
    sub = mr.Reference(_JAX, devices=8)
    yield sub
    sub.close()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The port's parameters (the reference's, unstacked) saved once."""
    jcfg = jx_reduced(jx_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jax.tree.map(np.asarray,
                           jx_init_params(jax.random.PRNGKey(0), jcfg))
    params = bridge.params_from_jax(jparams, cfg, device="cpu")
    ckpt = CheckpointManager(str(tmp_path_factory.mktemp("ckpt")),
                             async_write=False)
    ckpt.save(1, params)
    return ckpt, cfg, params


def _port_leaves(ref_key: str, cfg):
    """(port key, index into the reference's leaf) of each port leaf the
    reference leaf ``ref_key`` holds."""
    keys = ref_key.split("/")
    if keys[0] != "blocks":
        return [(ref_key, None)]
    period = len(cfg.block_pattern)
    slot = int(keys[1][len("slot"):])
    return [("/".join(["blocks", str(sb * period + slot), *keys[2:]]), sb)
            for sb in range(cfg.n_superblocks)]


def _reassemble(shards: list, key: str, full: torch.Tensor, specs, mesh):
    """The whole leaf put back together from every rank's shard."""
    spec = specs
    for part in key.split("/"):
        spec = spec[int(part)] if isinstance(spec, list) else spec[part]
    out = torch.full_like(full, float("nan")) if full.is_floating_point() \
        else torch.zeros_like(full)
    for r, tree in enumerate(shards):
        shard = dict(named_leaves(tree))[key]
        idx = []
        for d, entry in enumerate(spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            i = axes_index(mesh, rank_coords(mesh, r), axes)
            n = shard.shape[d]
            idx.append(slice(i * n, (i + 1) * n))
        out[tuple(idx)] = shard
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_elastic_restore_shards_equal_the_reference(ref, saved, shape):
    """Every rank's shard of every leaf is the reference's slice for that
    device, and the shards put back together are the saved leaves bit for
    bit."""
    ckpt, cfg, params = saved
    mesh = make_host_mesh(data=shape[0], model=shape[1], device="cpu")
    shards, got_mesh = elastic_restore(ckpt, 1, params, cfg, mesh=mesh)
    assert got_mesh is mesh and len(shards) == mesh.size
    want = ref.result()["%dx%d" % shape]
    full = dict(named_leaves(params))
    per_rank = [dict(named_leaves(t)) for t in shards]
    seen = set()
    for ref_key, rank_idx in want.items():
        for key, sb in _port_leaves(ref_key, cfg):
            seen.add(key)
            for r, idx in enumerate(rank_idx):
                idx = idx[1:] if sb is not None else idx
                sl = tuple(slice(a, b) for a, b in idx)
                assert torch.equal(per_rank[r][key], full[key][sl]), \
                    (shape, key, r, idx)
    assert seen == set(full)
    specs = shardings_for(params, param_specs(params, cfg, mesh), mesh)
    split = 0
    for key, leaf in full.items():
        back = _reassemble(shards, key, leaf, specs, mesh)
        assert torch.equal(back, leaf), key
        split += per_rank[0][key].shape != leaf.shape
    # only the model axis splits parameters
    assert (split > 0) == (shape[1] > 1)


def test_elastic_restore_defaults_to_the_visible_pool(saved):
    """``mesh=None``: ``plan_reshape`` over the visible devices, one rank
    on the CPU, whose shard is every whole leaf."""
    ckpt, cfg, params = saved
    shards, mesh = elastic_restore(ckpt, 1, params, cfg, device="cpu")
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert len(shards) == 1
    for (k, a), (_, b) in zip(named_leaves(shards[0]),
                              named_leaves(params)):
        assert torch.equal(a, b), k
