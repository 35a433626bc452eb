"""The port's Mamba layer against ``repro.layers.mamba`` on the reduced
Jamba config, in f32 on the CPU.

Weights come from the reference's init through ``repro_torch.bridge``;
inputs are seeded numpy.  A 300-token prefill crosses the reference's
``TIME_CHUNK`` (256: the reference pads the second chunk with dt = 0, the
port steps over the tokens it has), then four decode steps run from the
state it left; outputs and both state leaves agree within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.layers import mamba as jx_mamba
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.layers import mamba

torch.set_num_threads(2)
ARCH = "jamba-1.5-large-398b"
TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jp = jx_mamba.mamba_init(jax.random.PRNGKey(0), jcfg)
    # a conv bias the zero init would hide
    jp["conv_b"] = jnp.asarray(np.random.default_rng(1).standard_normal(
        jp["conv_b"].shape).astype(np.float32) * 0.1)
    params = {k: tensor_from_numpy(np.asarray(v), "cpu")
              for k, v in jp.items()}
    return jcfg, cfg, jp, params


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol)


def test_dims_and_init_match_the_reference(setup):
    jcfg, cfg, jp, _ = setup
    assert mamba._dims(cfg) == jx_mamba._dims(jcfg)
    mine = mamba.mamba_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(mine) == set(jp)
    for k, v in mine.items():
        assert tuple(v.shape) == jp[k].shape, k
        assert str(v.dtype).split(".")[-1] == jp[k].dtype.name, k
    for k in ("A_log", "D", "dt_b"):     # deterministic leaves
        _close(mine[k], jp[k], 0)
    state = mamba.make_state(cfg, 3, torch.float32, "cpu")
    assert state["conv"].shape == (3, cfg.mamba.d_conv - 1,
                                   mamba._dims(cfg)[0])
    assert state["h"].dtype == torch.float32


def test_conv_and_ssm_params_match(setup):
    jcfg, cfg, jp, params = setup
    di = mamba._dims(cfg)[0]
    x, prev = _x(2, (2, 7, di)), _x(3, (2, cfg.mamba.d_conv - 1, di))
    out, st = mamba._conv_causal(torch.from_numpy(x), params["conv_w"],
                                 params["conv_b"], torch.from_numpy(prev))
    jout, jst = jx_mamba._conv_causal(jnp.asarray(x), jp["conv_w"],
                                      jp["conv_b"], jnp.asarray(prev))
    _close(out, jout)
    _close(st, jst, 0)
    for got, want in zip(mamba._ssm_params(params, torch.from_numpy(x), cfg),
                         jx_mamba._ssm_params(jp, jnp.asarray(x), jcfg)):
        _close(got, want)


def test_prefill_across_time_chunks_then_decode(setup):
    """S = 300 > TIME_CHUNK, then 4 single-token steps, each from the
    state the last left; the port updates its state in place."""
    jcfg, cfg, jp, params = setup
    d = cfg.d_model
    x = _x(4, (2, 300, d)) * 0.5
    state = mamba.make_state(cfg, 2, torch.float32, "cpu")
    out, got = mamba.mamba_fwd(params, torch.from_numpy(x), cfg, state=state)
    assert got is state
    jout, jstate = jx_mamba.mamba_fwd(jp, jnp.asarray(x), jcfg)
    assert x.shape[1] > jx_mamba.TIME_CHUNK == mamba.TIME_CHUNK
    _close(out, jout)
    _close(state["h"], jstate["h"])
    _close(state["conv"], jstate["conv"])
    for step in range(4):
        x1 = _x(10 + step, (2, 1, d))
        out, _ = mamba.mamba_fwd(params, torch.from_numpy(x1), cfg,
                                 state=state)
        jout, jstate = jx_mamba.mamba_fwd(jp, jnp.asarray(x1), jcfg,
                                          state=jstate)
        _close(out, jout)
        _close(state["h"], jstate["h"])
        _close(state["conv"], jstate["conv"])


def test_given_projection_and_fresh_state(setup):
    """``xz`` (the model's fused norm+in_proj product) replaces the layer's
    own product; without a state the layer starts from zeros and returns
    a new one."""
    jcfg, cfg, jp, params = setup
    x = torch.from_numpy(_x(5, (1, 9, cfg.d_model)))
    out, st = mamba.mamba_fwd(params, x, cfg)
    out2, _ = mamba.mamba_fwd(params, x, cfg, xz=x @ params["in_proj"])
    assert torch.equal(out, out2)
    jout, jst = jx_mamba.mamba_fwd(jp, jnp.asarray(x.numpy()), jcfg)
    _close(out, jout)
    _close(st["h"], jst["h"])
