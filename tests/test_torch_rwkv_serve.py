"""The port's serving engine on reduced ``rwkv6-3b`` against the reference.

At prompt lengths that fill their power-of-two bucket (8, 16) the greedy
tokens are byte-identical to the JAX ``ServeEngine``'s.  At other lengths
the JAX engine runs its bucket's zero pad tokens through the recurrence
and the token shift, so its decode starts from another state; the port
prefills exactly the prompt, and its tokens equal the reference's
unpadded incremental ``forward`` loop (the pattern of
``tests/test_system.py``).  Also: a reused slot leaks no state, the paged
cache refuses the recurrent stack, and the serve CLI runs the model.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.inference.engine import Request as JxRequest
from repro.inference.engine import ServeEngine as JxServeEngine
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro.models import make_cache as jx_make_cache
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.launch import serve

torch.set_num_threads(2)
ARCH = "rwkv6-3b"
MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    jcfg = jx_reduced(jx_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jparams, params


def _prompts(plens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in plens]


def _incremental(jparams, jcfg, prompt, n_new):
    """Greedy tokens of the reference's forward, fed the prompt unpadded
    and then one token at a time (``tests/test_system.py``)."""
    cache = jx_make_cache(jcfg, 1, MAX_LEN, src_len=1)
    logits, _, cache = jx_forward(jparams, jnp.asarray([prompt], jnp.int32),
                                  jcfg, cache=cache,
                                  cache_index=jnp.zeros((), jnp.int32))
    seq = [int(jnp.argmax(logits[0, -1]))]
    for idx in range(len(prompt), len(prompt) + n_new - 1):
        logits, _, cache = jx_forward(
            jparams, jnp.asarray([[seq[-1]]], jnp.int32), jcfg, cache=cache,
            cache_index=jnp.asarray(idx, jnp.int32))
        seq.append(int(jnp.argmax(logits[0, 0])))
    return seq


def test_bucket_sized_prompts_match_the_reference_engine(setup):
    jcfg, cfg, jparams, params = setup
    prompts = _prompts([8, 16, 8, 16], cfg.vocab_size, 1)
    budgets = [6, 4, 7, 5]
    jreqs = [JxRequest(i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, budgets))]
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit")
    jeng.run(jreqs)
    reqs = [Request(i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, budgets))]
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      device="cpu")
    eng.run(reqs)
    for jr, r in zip(jreqs, reqs):
        assert r.status == jr.status == "done"
        assert r.generated == jr.generated, r.rid
    for field in ("prefills", "decode_steps", "tokens_out"):
        assert getattr(eng.stats, field) == getattr(jeng.stats, field)
    assert eng.stats.slot_occupancy == jeng.stats.slot_occupancy


def test_other_lengths_match_the_unpadded_incremental_forward(setup):
    jcfg, cfg, jparams, params = setup
    prompts = _prompts([5, 11, 5, 11], cfg.vocab_size, 2)
    n_new = 6
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      device="cpu")
    reqs = [Request(i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for r in reqs:
        assert r.generated == _incremental(jparams, jcfg, r.prompt, n_new), \
            r.rid
    # the reference engine pads these prompts and serves other tokens:
    # the inputs reach the fault this guards against
    jeng = JxServeEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                         plan="jit")
    jreqs = [JxRequest(i, prompt=p, max_new_tokens=n_new)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    assert any(jr.generated != r.generated for jr, r in zip(jreqs, reqs))


def test_slot_reuse_leaks_no_state(setup):
    """Counterpart of ``test_system.py::test_engine_slot_reuse_no_state_leak``:
    a slot reused by a second request serves what a fresh engine serves,
    and both equal the unpadded incremental forward."""
    jcfg, cfg, jparams, params = setup
    eng = ServeEngine(cfg, params, max_batch=1, max_len=MAX_LEN,
                      device="cpu")
    eng.run([Request(0, prompt=[5, 6, 7, 8], max_new_tokens=3)])
    got = eng.run([Request(2, prompt=[20, 21, 22, 23],
                           max_new_tokens=4)])[0].generated
    fresh = ServeEngine(cfg, params, max_batch=1, max_len=MAX_LEN,
                        device="cpu")
    want = fresh.run([Request(1, prompt=[20, 21, 22, 23],
                              max_new_tokens=4)])[0].generated
    assert got == want == _incremental(jparams, jcfg, [20, 21, 22, 23], 4)


def test_paged_cache_refuses_the_recurrent_stack(setup):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="pure-attention"):
        ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                    device="cpu", cache="paged")


def test_serve_cli_runs_rwkv(monkeypatch):
    from repro_torch import kernels
    calls = {"rmsnorm": 0, "wkv6": 0}
    for name in calls:
        fn = kernels.WRAPPERS[name]

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng, done = serve.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--requests", "3", "--max-batch", "2",
                                "--max-new", "4", "--no-warmup"])
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rep["arch"] == ARCH and rep["cache"] == "contiguous"
    assert rep["requests"] == 3 and rep["tokens_out"] == 12
    assert rep["prefills"] == 3 and rep["decode_steps"] > 0
    assert {"rmsnorm", "wkv6"} <= set(rep["kernel_launches_per_decode_step"])
    n, forwards = eng.cfg.n_layers, rep["prefills"] + rep["decode_steps"]
    assert calls == {"rmsnorm": forwards * (2 * n + 1), "wkv6": forwards * n}
    assert all(len(r.generated) == 4 for r in done)
