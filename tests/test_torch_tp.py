"""Tensor-parallel serving on the CPU: the sharding rules, the reduce hook,
the backend's validation and failure handling, and the contiguous cache at
tp=2 against the reference's tp=2.

The reference's ``ServeEngine(tp=2)`` runs in a subprocess that forces two
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``, as
``tests/test_backends.py`` does) and prints its results as JSON; it starts
with the first test and runs beside the port's engines.  The workload is
the reference test's: 4 requests of 8 prompt tokens and 6 new ones,
``max_batch=2``, ``max_len=32``.  The reduced configs' block weights are
scaled by 8 and their q/k/v biases drawn non-zero (the same values on both
sides), so greedy tokens depend on attention rather than repeat the last
token.  The port's ranks are processes of their own over gloo
(``inference.backends.sharded``); every test leaves none behind.
"""
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.distributed.sharding import cache_specs as jx_cache_specs
from repro.distributed.sharding import \
    paged_cache_specs as jx_paged_cache_specs
from repro.distributed.sharding import param_specs as jx_param_specs
from repro.inference.backends.sharded import _validate_tp as jx_validate_tp
from repro.launch.mesh import make_host_mesh as jx_make_host_mesh
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro.models import make_paged_cache as jx_make_paged_cache
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding
from repro_torch.inference.backends.sharded import ShardedBackend
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.launch import mesh, serve
from repro_torch.models import forward, make_cache, make_paged_cache

torch.set_num_threads(2)
ARCHS = ("smollm-360m", "llama-3.2-1b", "gemma2-27b", "codeqwen1.5-7b")
ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("collectives", "collective_bytes", "decode_collective_bytes",
            "decode_steps", "decode_dispatches", "prefills")

# the reference's side, run with two forced host devices; the same
# sharpening as ``_sharpen`` below
_JAX_TP2 = """
import json, zlib
import jax, numpy as np
from repro.configs import get_config, reduced
from repro.inference.engine import Request, ServeEngine
from repro.models import init_params

def sharpen(params):
    def f(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name in ("wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate"):
            return leaf * 8
        if name in ("bq", "bk", "bv"):
            rng = np.random.default_rng(
                zlib.crc32(jax.tree_util.keystr(path).encode()))
            return jax.numpy.asarray(rng.standard_normal(leaf.shape) * 0.1,
                                     leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(f, params)

out = {}
for arch in %r:
    cfg = reduced(get_config(arch))
    params = sharpen(init_params(jax.random.PRNGKey(0), cfg))
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, tp=2,
                      platform="Intel+H100")
    rng = np.random.default_rng(0)
    done = eng.run([Request(i, prompt=list(rng.integers(0, cfg.vocab_size,
                                                         8)),
                            max_new_tokens=6) for i in range(4)])
    st = eng.stats
    out[arch] = {"tokens": [[int(t) for t in r.generated]
                            for r in sorted(done, key=lambda r: r.rid)],
                 "tax": st.modeled_collective_tax_s,
                 "per_device": {str(k): v for k, v in
                                st.per_device_dispatches.items()},
                 **{k: getattr(st, k) for k in %r}}
print(json.dumps(out))
""" % (ARCHS, COUNTERS)


def _sharpen(params):
    """Block weights x 8, q/k/v biases drawn from their path's seed."""
    def f(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name in ("wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate"):
            return leaf * 8
        if name in ("bq", "bk", "bv"):
            rng = np.random.default_rng(
                zlib.crc32(jax.tree_util.keystr(path).encode()))
            return jax.numpy.asarray(rng.standard_normal(leaf.shape) * 0.1,
                                     leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(f, params)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(i, prompt=[int(t) for t in rng.integers(0, vocab, 8)],
                max_new_tokens=6) for i in range(4)]


def _tokens(done):
    return [list(r.generated) for r in sorted(done, key=lambda r: r.rid)]


class _Sub:
    """The reference's tp=2 run, started once and read when needed."""

    def __init__(self):
        env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=2",
               "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
               "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_JAX_TP2)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(ROOT))
        self._out = None

    def result(self) -> dict:
        if self._out is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err[-3000:]
            self._out = json.loads(out.strip().splitlines()[-1])
        return self._out


@pytest.fixture(scope="module", autouse=True)
def jax_tp2():
    sub = _Sub()
    yield sub
    if sub.proc.poll() is None:
        sub.proc.kill()
        sub.proc.communicate()


@pytest.fixture(autouse=True)
def no_rank_left():
    yield
    left = multiprocessing.active_children()
    assert not left, f"rank processes left alive: {left}"


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = jx_reduced(jx_get_config(arch))
        cfg = reduced(get_config(arch))
        jparams = _sharpen(jx_init_params(jax.random.PRNGKey(0), jcfg))
        params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cfg, device="cpu")
        out[arch] = (jcfg, cfg, jparams, params)
    return out


# ------------------------------------------------------------ sharding
def _port_path(keys, cfg):
    """The port's leaf path for a reference path, and whether the
    reference's leaf carries the superblock axis."""
    if keys[0] in ("blocks", "enc_blocks"):
        period = 1 if keys[0] == "enc_blocks" else len(cfg.block_pattern)
        slot = int(keys[1][len("slot"):])
        return (keys[0], slot, *keys[2:]), True, period
    return tuple(keys), False, 1


@pytest.mark.parametrize("arch", ARCHS + (
    "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "rwkv6-3b",
    "seamless-m4t-medium"))
def test_param_specs_equal_the_reference(arch):
    """Every leaf's split dimension equals the reference's ``param_specs``
    over a stub (data=1, model=2) mesh, the superblock axis aside; then
    ``shard_params`` cuts each split leaf to its rank's slice."""
    from repro_torch.models import init_params
    jcfg = jx_reduced(jx_get_config(arch))
    cfg = reduced(get_config(arch))
    stub = types.SimpleNamespace(shape={"data": 1, "model": 2})
    jparams = jax.eval_shape(
        lambda: jx_init_params(jax.random.PRNGKey(0), jcfg))
    jspecs = jx_param_specs(jparams, jcfg, stub, tp="model")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = sharding.param_specs(params, cfg, stub)
    n = 0
    for path, jspec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                 PartitionSpec))[0]:
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        ppath, stacked, period = _port_path(keys, cfg)
        jdim = next((d for d, a in enumerate(jspec) if a == "model"), None)
        if stacked and jdim is not None:
            jdim -= 1
        n_sb = (cfg.n_encoder_layers if keys[0] == "enc_blocks"
                else cfg.n_superblocks) if stacked else 1
        for sb in range(n_sb):
            spec = specs
            for i, k in enumerate(ppath):
                if i == 1 and stacked:
                    k = sb * period + k
                spec = spec[k]
            assert sharding.split_dim(spec) == jdim, (keys, spec, jspec)
            n += 1
    assert n > 0
    if arch not in ARCHS:
        return
    for rank in (0, 1):
        shard = sharding.shard_params(params, cfg, 2, rank)
        wq = params["blocks"][0]["mixer"]["wq"]
        assert torch.equal(shard["blocks"][0]["mixer"]["wq"],
                           wq[:, rank * wq.shape[1] // 2:
                              (rank + 1) * wq.shape[1] // 2])
        wo = params["blocks"][0]["mixer"]["wo"]
        assert torch.equal(shard["blocks"][0]["mixer"]["wo"],
                           wo.chunk(2, 0)[rank])
        assert shard["blocks"][0]["mlp"]["w_out"].shape[0] == cfg.d_ff // 2
        # the embedding (and an untied head) stay whole and shared
        assert shard["embed"] is params["embed"]
        assert shard.get("lm_head") is params.get("lm_head")


@pytest.mark.parametrize("arch", ("smollm-360m", "gemma2-27b"))
def test_cache_specs_equal_the_reference(arch):
    """The contiguous cache's and the paged pool's (bf16 and int8) split
    dimensions equal the reference's, the superblock axis aside."""
    jcfg = jx_reduced(jx_get_config(arch))
    cfg = reduced(get_config(arch))
    jmesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    checks = [(jx_cache_specs(jx_make_cache(jcfg, 2, 16), jcfg, jmesh),
               sharding.cache_specs(make_cache(cfg, 2, 16, device="cpu"),
                                    cfg, jmesh))]
    for kv in ("bf16", "int8"):
        checks.append((
            jx_paged_cache_specs(jx_make_paged_cache(jcfg, 6, 4,
                                                     kv_dtype=kv),
                                 jcfg, jmesh),
            sharding.paged_cache_specs(make_paged_cache(
                cfg, 6, 4, kv_dtype=kv, device="cpu"), cfg, jmesh)))
    for jspecs, specs in checks:
        jleaves = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]
        for path, jspec in jleaves:
            keys = [getattr(p, "key", getattr(p, "name", None))
                    for p in path]
            jdim = next((d - 1 for d, a in enumerate(jspec)
                         if a == "model"), None)
            for layer in specs:
                assert sharding.split_dim(layer[keys[-1]]) == jdim, keys


def test_mesh_rules():
    """The port's mesh keeps the reference's axes and errors; on the CPU
    every rank runs on the CPU."""
    m = mesh.make_host_mesh(data=1, model=2, device="cpu")
    assert m.shape == {"data": 1, "model": 2} and m.size == 2
    assert m.devices == (torch.device("cpu"),) * 2
    assert mesh.dp_axes_of(m) == ("data",) and mesh.tp_axis_of(m) == "model"
    f = mesh.make_fleet_mesh(3, tp=2, device="cpu")
    assert f.shape == {"data": 3, "model": 2}
    pod = mesh.make_host_mesh(data=1, model=1, pod=2, device="cpu")
    assert mesh.dp_axes_of(pod) == ("pod", "data")
    for call, jcall in ((lambda: mesh.make_host_mesh(data=0, device="cpu"),
                         lambda: jx_make_host_mesh(data=0)),
                        (lambda: mesh.make_host_mesh(model=-2,
                                                     device="cpu"),
                         lambda: jx_make_host_mesh(model=-2))):
        with pytest.raises(ValueError, match="must be >= 1") as e:
            call()
        with pytest.raises(ValueError) as je:
            jcall()
        assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        mesh.make_fleet_mesh(0, device="cpu")


def test_reduce_hook(models):
    """``reduce=None`` computes what the port always did; a hook sees each
    layer's attention and MLP partial output once, in order, and what it
    returns is what the stack goes on with."""
    _, cfg, _, params = models["gemma2-27b"]
    toks = torch.from_numpy(np.arange(10, dtype=np.int64).reshape(2, 5))
    base, _ = forward(params, toks, cfg)
    seen = []

    def hook(name, x):
        seen.append((name, tuple(x.shape)))
        return x
    same, _ = forward(params, toks, cfg, reduce=hook)
    assert torch.equal(base, same)
    assert seen == [("attn_out", (2, 5, 64)), ("mlp_out", (2, 5, 64))] \
        * cfg.n_layers
    doubled, _ = forward(params, toks, cfg,
                         reduce=lambda name, x: x * 2 if name == "mlp_out"
                         else x)
    assert not torch.equal(base, doubled)


# ------------------------------------------------------------ validation
def test_validation_raises_the_reference_errors(models):
    """``tp must be >= 1``, then the divisibility, plan and stack checks,
    each in the reference's words, before any rank starts."""
    jcfg, cfg, _, params = models["smollm-360m"]
    with pytest.raises(ValueError, match="tp must be >= 1"):
        ServeEngine(cfg, params, device="cpu", tp=0)
    with pytest.raises(ValueError, match="must divide n_heads"):
        ServeEngine(cfg, params, device="cpu", tp=3)
    with pytest.raises(ValueError, match="plan='jit' only"):
        ServeEngine(cfg, params, device="cpu", tp=2, plan="eager")
    with pytest.raises(ValueError, match="needs tp >= 2"):
        ShardedBackend(cfg, params, max_batch=1, max_len=8, tp=1,
                       device="cpu")
    for arch in ("rwkv6-3b", "moonshot-v1-16b-a3b", "seamless-m4t-medium",
                 "jamba-1.5-large-398b", "llama-3.2-vision-11b"):
        c, jc = reduced(get_config(arch)), jx_reduced(jx_get_config(arch))
        with pytest.raises(ValueError) as e:
            ShardedBackend(c, params, max_batch=1, max_len=8, tp=2,
                           device="cpu")
        with pytest.raises(ValueError) as je:
            jx_validate_tp(jc, 2)
        assert str(e.value) == str(je.value)
        assert "pure-attention decoder stacks" in str(e.value)
    c3 = cfg.replace(d_ff=129)
    with pytest.raises(ValueError) as e:
        ShardedBackend(c3, params, max_batch=1, max_len=8, tp=2,
                       device="cpu")
    with pytest.raises(ValueError) as je:
        jx_validate_tp(jcfg.replace(d_ff=129), 2)
    assert str(e.value) == str(je.value)


def test_a_dead_rank_raises(models):
    """A rank that stops makes the next step raise within the group's
    timeout, and the backend stops its other ranks and refuses more."""
    _, cfg, _, params = models["smollm-360m"]
    be = ShardedBackend(cfg, params, max_batch=2, max_len=32, tp=2,
                        device="cpu", timeout_s=20)
    cache = be.init_contiguous_cache()
    be.prefill(cache, np.arange(8)[None], 0, 8)
    assert be.probe_exchange(3, 1024) > 0
    be._workers.procs[0].kill()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        be.decode(cache, np.zeros((2, 1)), np.array([8, 0]))
    assert time.perf_counter() - t0 < 20
    with pytest.raises(RuntimeError, match="closed"):
        be.decode(cache, np.zeros((2, 1)), np.array([8, 0]))


# ------------------------------------------------------------ serving
def _serve(cfg, params, arch):
    """One tp=2 engine from start to close (in a thread of its own): its
    tokens, stats and devices; smollm's served again after ``reset``."""
    with ServeEngine(cfg, params, max_batch=2, max_len=32, tp=2,
                     device="cpu") as eng:
        got = _tokens(eng.run(_requests(Request, cfg.vocab_size)))
        st, again, again_pd = eng.stats, None, None
        if arch == "smollm-360m":
            eng.reset()
            again = _tokens(eng.run(_requests(Request, cfg.vocab_size)))
            again_pd = eng.stats.per_device_dispatches
        return got, st, eng.backend.info.devices, again, again_pd


@pytest.fixture(scope="module")
def served(models):
    """Every arch's tp=2 engine, started together (a rank takes seconds
    to start: it imports torch) and closed before this returns."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {arch: pool.submit(_serve, models[arch][1], models[arch][3],
                                  arch)
                for arch in ARCHS}
        return {arch: f.result() for arch, f in futs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_tp2_equals_the_reference_tp2(jax_tp2, models, served,
                                                 arch):
    """Tokens, collectives, their bytes and modeled tax (``Intel+H100``),
    and the per-rank dispatches equal the reference's tp=2; every call is
    charged one dispatch a rank; after ``reset`` (zeroing every rank's
    cache) the same tokens come again."""
    cfg = models[arch][1]
    got, st, devices, again, again_pd = served[arch]
    assert devices == ("cpu", "cpu")
    if arch == "smollm-360m":
        assert again == got and again_pd == st.per_device_dispatches
    want = jax_tp2.result()[arch]
    assert got == want["tokens"]
    for k in COUNTERS:
        assert getattr(st, k) == want[k], k
    assert st.modeled_collective_tax_s == pytest.approx(want["tax"],
                                                        rel=1e-12)
    assert {str(k): v for k, v in st.per_device_dispatches.items()} \
        == want["per_device"]
    assert st.per_device_dispatches[0] == st.per_device_dispatches[1]
    assert st.decode_dispatches == 2 * st.decode_steps
    assert st.collective_bytes_per_decode_step == (
        2 * cfg.n_layers * 2 * cfg.d_model * 4)
    if arch == "smollm-360m":       # the reference test's figures
        assert (st.collectives, st.collective_bytes, st.decode_steps) == (
            56, 53248, 10)


def test_serve_cli_tp2_reports_the_collectives(capsys):
    """``serve --tp 2`` reports the reference's fields (its
    ``test_sharded_serve_cli_reports_tp_counters``)."""
    serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                "--max-batch", "2", "--max-new", "3", "--max-len", "64",
                "--tp", "2", "--no-warmup"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["tp"] == 2 and rep["devices"] == ["cpu", "cpu"]
    assert set(rep["per_device_dispatches"]) == {"0", "1"}
    assert rep["collective_bytes"] > 0
    assert rep["modeled_collective_tax_us"] > 0
    assert rep["collective_bytes_per_decode_step"] > 0
    assert rep["requests"] == 3
