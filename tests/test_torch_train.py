"""The port's optimizers, data pipeline, checkpoint manager and Trainer:
the counterparts of ``tests/test_optim_data_ckpt.py``, each held against
the reference where the reference computes the same thing.

Optimizer parity: the same parameters and the same gradient sequence (made
with numpy) through ``repro.training.optim`` and the port's in-place
updates, 5 steps, parameters and state within 1e-6 in f32; with bf16
parameters the state within 1e-6 and each parameter within one bf16 ulp
(an f32 update one ulp apart may round to the neighbouring bf16 value).
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.data.pipeline import DataConfig as JxDataConfig
from repro.models import init_params as jx_init_params
from repro.training import optim as jx_optim
from repro.training.loop import TrainConfig as JxTrainConfig
from repro.training.loop import Trainer as JxTrainer
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, Pipeline, make_batch
from repro_torch.training.loop import StragglerWatchdog, TrainConfig, Trainer
from repro_torch.training.optim import (OptConfig, adafactor_init,
                                        adafactor_update, adamw_init,
                                        adamw_update, clip_by_global_norm,
                                        global_norm, opt_init, opt_update,
                                        schedule)
from repro_torch.tree import leaves, map_tree, named_leaves

torch.set_num_threads(2)
SHAPES = {"a": (2,), "w": (6, 8), "experts": (3, 4, 5), "col": (7, 1),
          "nested": {"b": (4,), "m": (5, 3)}}


def _to_torch(tree, dtype):
    return map_tree(lambda a: torch.from_numpy(np.asarray(a, np.float32))
                    .to(dtype), tree)


def _np_tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _np_tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(kind):
    w = {"a": torch.tensor([3.0, -2.0]), "b": torch.ones((4, 8)) * 2}
    cfg = OptConfig(kind=kind, lr=0.1, weight_decay=0.0, warmup_steps=0,
                    total_steps=100, min_lr_frac=1.0)
    state = opt_init(cfg, w)

    def loss(p):
        return sum((x ** 2).sum() for x in leaves(p))
    l0 = float(loss(w))
    for _ in range(50):
        grads = map_tree(lambda x: 2 * x, w)
        w, state, _ = opt_update(cfg, grads, state, w)
    assert float(loss(w)) < 0.05 * l0


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_the_reference(kind, dtype):
    rng = np.random.default_rng(11)
    init = _np_tree(rng, SHAPES)
    grads = [_np_tree(rng, SHAPES, scale=0.5 + s) for s in range(5)]
    cfg = OptConfig(kind=kind, lr=0.05, warmup_steps=2, total_steps=8,
                    clip_norm=3.0)
    jcfg = jx_optim.OptConfig(**cfg.__dict__)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), init)
    js = jx_optim.opt_init(jcfg, jp)
    tp = _to_torch(init, tdt)
    ts = opt_init(cfg, tp)
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
        jp, js, jm = jx_optim.opt_update(jcfg, jg, js, jp)
        tp, ts, tm = opt_update(cfg, _to_torch(g, tdt), ts, tp)
        assert abs(tm["lr"] - float(jm["lr"])) <= 1e-7
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    assert int(ts["step"]) == int(js["step"]) == 5
    want_state = dict(named_leaves(jax.tree.map(np.asarray, js)))
    for key, leaf in named_leaves(ts):
        if key != "step":
            np.testing.assert_allclose(leaf.numpy(), want_state[key],
                                       rtol=1e-6, atol=1e-7, err_msg=key)
    want = dict(named_leaves(jax.tree.map(_as_f32, jp)))
    for key, leaf in named_leaves(tp):
        assert leaf.dtype == tdt, key
        got = _as_f32(leaf)
        if dtype == "float32":
            np.testing.assert_allclose(got, want[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)
        else:
            ulp = np.abs(want[key]) * 2.0 ** -7
            assert np.all(np.abs(got - want[key]) <= ulp + 1e-30), key


def test_clip_preserves_dtype_and_norm():
    g = {"x": torch.ones((1000,), dtype=torch.bfloat16) * 10}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert clipped["x"].dtype == torch.bfloat16
    assert float(global_norm(clipped)) < 1.1
    jc, jn = jx_optim.clip_by_global_norm(
        {"x": jnp.ones((1000,), jnp.bfloat16) * 10}, 1.0)
    assert abs(float(norm) - float(jn)) <= 1e-6 * float(jn)
    np.testing.assert_array_equal(_as_f32(clipped["x"]),
                                  _as_f32(jc["x"]))


def test_schedule_warmup_and_decay():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    assert schedule(cfg, 0) == 0.0
    assert abs(schedule(cfg, 10) - 1.0) < 1e-3
    assert schedule(cfg, 100) <= 0.11
    jcfg = jx_optim.OptConfig(**cfg.__dict__)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        assert abs(schedule(cfg, step)
                   - float(jx_optim.schedule(jcfg, jnp.asarray(step)))) \
            <= 1e-7


# ------------------------------------------------------------ data
def test_data_deterministic_and_seekable():
    cfg = DataConfig(seed=7, batch=2, seq_len=16, vocab_size=100)
    b1 = make_batch(cfg, 5)
    b2 = make_batch(cfg, 5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    p = Pipeline(cfg, start_step=5)
    b3 = next(p)
    b4 = next(p)
    p.close()
    np.testing.assert_array_equal(b1["tokens"], b3["tokens"])
    np.testing.assert_array_equal(make_batch(cfg, 6)["labels"],
                                  b4["labels"])
    assert p.step == 7
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


# ------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip_and_integrity(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_write=False)
    bits = torch.randint(-2 ** 15, 2 ** 15, (5, 7), dtype=torch.int16)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "step": torch.tensor(4, dtype=torch.int32),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16),
                       "blocks": [{"w": bits.view(torch.bfloat16)}]}}
    ckpt.save(3, tree)
    assert ckpt.latest_step() == 3
    d = tmp_path / "step_00000003"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["leaves"]["nested/blocks/0/w"]["dtype"] == "bfloat16"
    restored = ckpt.restore(3, tree)
    np.testing.assert_array_equal(restored["a"].numpy(), tree["a"].numpy())
    assert int(restored["step"]) == 4
    assert restored["nested"]["b"].dtype == torch.bfloat16
    w = restored["nested"]["blocks"][0]["w"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(w.view(torch.int16), bits)   # bit for bit, NaNs too
    # corruption detection
    victim = next(f for f in sorted(os.listdir(d)) if f.endswith(".npy"))
    arr = np.load(d / victim).copy()
    arr.flat[0] += 1
    np.save(d / victim, arr)
    with pytest.raises(IOError):
        ckpt.restore(3, tree)


def test_checkpoint_async_write_copies_before_returning(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    x = torch.zeros(1000)
    ckpt.save(1, {"x": x})
    x.add_(1.0)                      # the trainer updates in place
    ckpt.wait()
    assert float(ckpt.restore(1, {"x": x})["x"].sum()) == 0.0


def test_checkpoint_gc_keeps_latest_and_ignores_uncommitted(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": torch.zeros(1)})
    assert ckpt.all_steps() == [3, 4]
    # a torn save: the directory is there, its COMMIT is not
    os.makedirs(tmp_path / "step_00000009")
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4


# ------------------------------------------------------------ trainer FT
def _trainer(tmp_path, fail=None, steps=12):
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    data = DataConfig(batch=2, seq_len=32, vocab_size=cfg.vocab_size)
    return Trainer(cfg, data, TrainConfig(steps=steps, ckpt_every=4,
                                          ckpt_dir=str(tmp_path),
                                          fail_at_step=fail),
                   device="cpu")


def test_trainer_failure_resume_exact(tmp_path):
    ref = _trainer(tmp_path).run()
    shutil.rmtree(tmp_path)
    with pytest.raises(RuntimeError, match="simulated failure at 8"):
        _trainer(tmp_path, fail=8).run()
    assert CheckpointManager(str(tmp_path)).latest_step() == 8
    out = _trainer(tmp_path).run()
    assert out["final_step"] == 12
    assert [h["step"] for h in out["history"]] == list(range(8, 12))
    # resumed training gives the uninterrupted run's losses exactly
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"][8:]]
    for a, b in zip(leaves(out["params"]), leaves(ref["params"])):
        assert torch.equal(a, b)


def test_trainer_matches_the_reference_trainer(tmp_path):
    """From the reference's initial weights (``init_state`` overridden
    through the bridge), 5 steps of the same data give the reference
    Trainer's losses within 1e-5 relative (f32; other summation order)."""
    steps = 5
    jcfg = jx_reduced(jx_get_config("smollm-360m"), n_layers=2)
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    kw = dict(batch=2, seq_len=32, vocab_size=cfg.vocab_size)
    jref = JxTrainer(jcfg, JxDataConfig(**kw),
                     JxTrainConfig(steps=steps, ckpt_every=100,
                                   ckpt_dir=str(tmp_path / "jax"))).run()
    trainer = Trainer(cfg, DataConfig(**kw),
                      TrainConfig(steps=steps, ckpt_every=100,
                                  ckpt_dir=str(tmp_path / "port")),
                      device="cpu")
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    trainer.init_state = lambda: (params, opt_init(trainer.opt_cfg, params),
                                  0)
    out = trainer.run()
    want = [h["loss"] for h in jref["history"]]
    got = [h["loss"] for h in out["history"]]
    assert len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_straggler_watchdog():
    w = StragglerWatchdog(window=10, z=3.0)
    for i in range(8):
        assert not w.observe(i, 0.1 + 0.001 * (i % 2))
    assert w.observe(8, 5.0)        # 50x outlier flagged
    assert w.flagged[0][0] == 8


def test_train_cli_reduces_loss(tmp_path):
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "30", "--batch", "4", "--seq", "64",
         "--ckpt-dir", str(tmp_path)],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["arch"] == "smollm-360m" and line["steps"] == 30
    assert line["loss_last"] < line["loss_first"] - 0.3, line
    assert sorted(line) == ["arch", "loss_first", "loss_last", "steps",
                            "stragglers", "wall_s"]


def test_trainer_needs_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid")
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, DataConfig(), TrainConfig(ckpt_dir=str(tmp_path)))
