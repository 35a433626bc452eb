"""Int8 compressed data-parallel gradients over 4 gloo ranks on the CPU,
against the reference's ``repro.distributed.compression``.

The reference's ``compressed_psum`` and ``make_compressed_dp_grad`` run
under ``shard_map`` in a subprocess with 4 forced host devices; its
``_quantize`` runs here.  Both sides get the same per-rank gradients and
error states, made from a seed with numpy (``_INPUTS``).  The port's ranks
are one pool of 4 processes for the module (``distributed.ranks``); no
test leaves one behind.
"""
import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multirank as mr
from repro.distributed.compression import _quantize as jx_quantize
from repro_torch.distributed.compression import (_quantize, init_error_state,
                                                 wire_bytes)
from repro_torch.distributed.ranks import RankPool
from repro_torch.launch.mesh import make_host_mesh

torch.set_num_threads(2)
N = 4

# per-rank gradients (one bf16 leaf) and carried errors, both sides
_INPUTS = """
import numpy as np
SHAPES = {"w": (8, 8), "b": (5,), "h": (3, 4)}
BF16 = ("h",)
def inputs(n):
    rng = np.random.default_rng(7)
    g = {k: rng.standard_normal((n,) + s).astype(np.float32) * (1 + i)
         for i, (k, s) in enumerate(SHAPES.items())}
    e = {k: rng.standard_normal((n,) + s).astype(np.float32) * 0.01
         for k, s in SHAPES.items()}
    return g, e
"""
exec(_INPUTS)

_JAX = _INPUTS + """
import json, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.compat import shard_map
from repro.distributed.compression import (
    compressed_psum, init_error_state, make_compressed_dp_grad)
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(data=4, model=1)
g, e = inputs(4)
g = {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
     for k, v in g.items()}
e = {k: jnp.asarray(v) for k, v in e.items()}

def body(g, e):
    g, e = (jax.tree.map(lambda a: a[0], t) for t in (g, e))
    m, ne = compressed_psum(g, e, "data")
    m2, ne2 = compressed_psum(g, ne, "data")
    return tuple(jax.tree.map(lambda a: a[None], t) for t in (m, ne, m2, ne2))

spec = P("data")
outs = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                 out_specs=(spec,) * 4, check_vma=False)(g, e)
res = {name: {k: np.asarray(v, np.float32).tolist() for k, v in t.items()}
       for name, t in zip(("mean", "err", "mean2", "err2"), outs)}

# the reference test's case
w = {"w": jnp.asarray(np.random.default_rng(0).standard_normal((8, 8)),
                      jnp.float32)}
x = jnp.asarray(np.random.default_rng(1).standard_normal((8, 8)),
                jnp.float32)
def loss(p, b):
    return jnp.mean((b @ p["w"]) ** 2), 0.0
step = make_compressed_dp_grad(loss, mesh, "data")
gd, _, lv = step(w, init_error_state(w), x)
res["dp_grad"] = np.asarray(gd["w"]).tolist()
res["dp_loss"] = float(lv)
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref():
    sub = mr.Reference(_JAX, devices=N)
    yield sub
    sub.close()


@pytest.fixture(scope="module")
def pool(ref):
    with RankPool(N, device="cpu") as p:
        yield p


def _port_inputs():
    g, e = inputs(N)
    per_rank = []
    for r in range(N):
        gr = {k: torch.from_numpy(v[r]).to(
            torch.bfloat16 if k in BF16 else torch.float32)
            for k, v in g.items()}
        per_rank.append((gr, {k: torch.from_numpy(v[r])
                              for k, v in e.items()}))
    return per_rank


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_equals_the_reference(dtype):
    """Payload, scale and carried error of one leaf, bit for bit, at the
    rounding boundaries too (x / scale exactly k + 0.5: half to even)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 7)).astype(np.float32)
    x[0, :4] = [127.0, -127.0, 0.5, 2.5]        # scale 1: ties at 0.5, 2.5
    err = (rng.standard_normal((6, 7)) * 1e-3).astype(np.float32)
    err[0, :4] = 0.0
    jx = jx_quantize(jnp.asarray(x, dtype), jnp.asarray(err))
    tq = _quantize(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(err))
    assert tq[0].dtype == torch.int8 and tq[1].dtype == torch.float32
    np.testing.assert_array_equal(tq[0].numpy(), np.asarray(jx[0]))
    assert float(tq[1]) == float(jx[1])
    np.testing.assert_array_equal(tq[2].numpy(), np.asarray(jx[2]))
    if dtype == "float32":
        assert tq[0][0, :4].tolist() == [127, -127, 0, 2]


def test_compressed_psum_equals_the_reference(pool, ref):
    """Over 4 data ranks fed the reference's per-rank gradients: the same
    int8 payloads and scales exactly, the same mean and new error state
    within 1e-6, for two steps of error feedback."""
    mesh = make_host_mesh(data=N, model=1, device="cpu")
    per_rank = _port_inputs()
    outs = pool.run(mr.compression_body, mesh, per_rank)
    res = ref.result()
    for r, (out, (g, e)) in enumerate(zip(outs, per_rank)):
        for k in g:
            jq, js, _ = jx_quantize(jnp.asarray(
                g[k].float().numpy(),
                jnp.bfloat16 if k in BF16 else jnp.float32),
                jnp.asarray(e[k].numpy()))
            np.testing.assert_array_equal(out["q"][k].numpy(),
                                          np.asarray(jq))
            assert float(out["scale"][k]) == float(js), (r, k)
        for name in ("mean", "err", "mean2", "err2"):
            for k, v in out[name].items():
                want = np.asarray(res[name][k][r], np.float32)
                if name.startswith("mean"):
                    assert v.dtype == g[k].dtype, (name, k, v.dtype)
                np.testing.assert_allclose(v.float().numpy(), want,
                                           rtol=0, atol=1e-6,
                                           err_msg=f"{name} {k} rank {r}")
    # the mean is the same on every rank
    for out in outs[1:]:
        for k, v in out["mean"].items():
            assert torch.equal(v, outs[0]["mean"][k])


def test_compressed_dp_grad_close_to_exact(pool, ref):
    """The reference test's case (w 8 x 8, x 8 x 8, 2 rows a rank): within
    0.05 relative of the exact gradient, and within one quantization step
    (the largest rank's scale / n) of the reference's per element."""
    mesh = make_host_mesh(data=N, model=1, device="cpu")
    w = {"w": torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))}
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((8, 8)).astype(np.float32))
    outs = pool.run(mr.dp_grad_body, mesh,
                    [(w, x[2 * r:2 * r + 2]) for r in range(N)])
    wx = w["w"].clone().requires_grad_(True)
    exact, = torch.autograd.grad(mr.quad_loss({"w": wx}, x)[0], [wx])
    scales = []
    for r in range(N):
        wr = w["w"].clone().requires_grad_(True)
        gr, = torch.autograd.grad(
            mr.quad_loss({"w": wr}, x[2 * r:2 * r + 2])[0], [wr])
        scales.append(float(gr.abs().max()) / 127)
    res = ref.result()
    for g, errs, loss in outs:
        rel = float((g["w"] - exact).norm() / exact.norm())
        assert rel < 0.05, rel
        step = max(scales) / N
        diff = (g["w"] - torch.tensor(res["dp_grad"])).abs().max()
        assert float(diff) <= step, (float(diff), step)
        assert abs(float(loss) - res["dp_loss"]) < 1e-5
        assert torch.equal(g["w"], outs[0][0]["w"])
        assert errs["w"].dtype == torch.float32


def test_wire_carries_int8_and_one_scale_a_leaf():
    g = {"w": torch.zeros(8, 8), "b": torch.zeros(5, dtype=torch.bfloat16)}
    assert init_error_state(g)["b"].dtype == torch.float32
    wb = wire_bytes(g, 2)
    # 69 payload bytes and 2 scales each way to the one peer
    assert wb == {"int8": 2 * (69 + 8), "f32_allreduce": 2 * 69 * 4}


def test_zz_the_pool_closes(pool):
    """Last in the module: the shared pool's ranks end with it."""
    assert len(pool.procs) == N and all(p.is_alive() for p in pool.procs)
    pool.close()
    assert not multiprocessing.active_children()
