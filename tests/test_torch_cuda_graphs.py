"""The serving steps as CUDA graphs (``plan="jit"``) against eager, on the card.

Marked ``cuda``: each test skips without a GPU.  On a machine with one (and
without JAX, so without this directory's conftest):

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda_graphs.py

Reduced configs (2 layers, f32, TF32 off) with random weights: tokens under
capture and replay equal eager's and the fused plan's in every cache mode
and on RWKV-6; a replay after ``reset()`` and after other graphs ran (RWKV
prefill, whose ``wkv6`` chunk kernel bakes tensor maps into the graph)
gives the same bits as the fused plan (the same kernels); a cache built
anew is captured anew; the decode kernel's split path (``max_len`` 256: two
splits and their arrival counters) works under capture; a body that cannot
be captured raises; and a chain or fused launch plan of the decode body,
captured one graph a segment, replays the same plan's direct output bit for
bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.core.tracing import trace_fn
from repro_torch.inference.backends import LocalBackend
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.kernels.decode_attention.ops import split_plan
from repro_torch.models import init_params, make_cache, make_paged_cache
from repro_torch.runtime import PlanExecutor, Planner
from repro_torch.telemetry.spans import SpanRecorder

pytestmark = pytest.mark.cuda
MAX_LEN = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, dev):
    cfg = reduced(get_config(arch))
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)


def _requests(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, prompt=[int(t) for t in rng.integers(0, vocab,
                                                            5 + 3 * i)],
                    max_new_tokens=6 + i) for i in range(n)]


CASES = {
    "contiguous": ("smollm-360m", dict()),
    "paged_bf16": ("smollm-360m", dict(cache="paged", block_size=8)),
    "int8_pressure": ("smollm-360m", dict(
        cache="paged", kv_dtype="int8", block_size=4, num_blocks=8,
        prefill_chunk=4, offload="host", share_prefix=True)),
    "rwkv": ("rwkv6-3b", dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphs_serve_the_eager_tokens(dev, case):
    """jit (one graph a step) serves eager's tokens and the fused plan's
    (one graph a segment, the same kernels), with the fused plan's
    hand-written launches; eager runs the norms as their plain versions,
    so only its attention (or wkv6) launches."""
    arch, kw = CASES[case]
    cfg, params = _model(arch, dev)
    engines, tokens = {}, {}
    for plan in ("eager", "fused", "jit"):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                          plan=plan, device=dev, **kw)
        tokens[plan] = [{r.rid: r.generated
                         for r in eng.run(_requests(cfg.vocab_size,
                                                    seed=seed))}
                        for seed in (0, 1)]
        engines[plan] = eng
    assert tokens["jit"] == tokens["eager"] == tokens["fused"]
    je, ee, fe = engines["jit"], engines["eager"], engines["fused"]
    assert je.backend.graph_stats.captured > 0
    assert je.backend.graph_stats.memory_bytes > 0
    assert je.stats.dispatches_per_decode_step == 1.0
    # eager: one dispatch a node of the traced step
    assert ee.stats.dispatches_per_decode_step == \
        len(ee.backend.planned_decode.trace.kernels)
    launches = {p: {k: v for k, v in
                    e.stats.kernel_launches_per_decode_step.items() if v}
                for p, e in engines.items()}
    legacy = launches["jit"].pop("rmsnorm", 0)     # fused lowers RWKV's
    if legacy:                                     # legacy-norm windows
        launches["jit"]["residual_rmsnorm"] = legacy
    assert launches["jit"] == launches["fused"]
    assert set(launches["eager"]) == set(launches["jit"]) - {
        "residual_rmsnorm", "rmsnorm_matmul"}
    if case == "int8_pressure":
        assert je.stats.preemptions > 0 and je.stats.restore_bytes > 0


def test_replay_after_reset(dev):
    cfg, params = _model("smollm-360m", dev)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device=dev)
    first = [r.generated for r in eng.run(_requests(cfg.vocab_size))]
    captured = eng.backend.graph_stats.captured
    eng.reset()
    again = [r.generated for r in eng.run(_requests(cfg.vocab_size))]
    assert again == first
    assert eng.backend.graph_stats.captured == captured   # all replays


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


def test_replay_after_other_graphs_ran(dev):
    """RWKV prefill: slot 0 at 12 tokens (graph A), slot 1 at 7 tokens
    (graph B), then graph A again on the same tokens: the same logits as
    its first replay and as the fused plan's, the same kernels (``wkv6``'s
    tensor maps hold the addresses of A's own pool)."""
    cfg, params = _model("rwkv6-3b", dev)
    out = {}
    for plan in ("fused", "jit"):
        be = LocalBackend(cfg, params, max_batch=2, max_len=MAX_LEN,
                          plan=plan, device=dev)
        cache = be.init_contiguous_cache()
        a1 = be.prefill(cache, _prompt(cfg.vocab_size, 12, 0), 0, 12)[0]
        a1 = a1.clone()
        be.prefill(cache, _prompt(cfg.vocab_size, 7, 1), 1, 7)
        a2 = be.prefill(cache, _prompt(cfg.vocab_size, 12, 0), 0, 12)[0]
        out[plan] = (a1, a2.clone(), [t.clone() for c in cache
                                      for t in c.values()])
        if plan == "jit":
            assert be.graph_stats.captured == 2
    assert torch.equal(out["jit"][0], out["jit"][1])
    assert torch.equal(out["jit"][0], out["fused"][0])
    for a, b in zip(out["jit"][2], out["fused"][2]):
        assert torch.equal(a, b)


def test_new_cache_is_captured_anew(dev):
    cfg, params = _model("smollm-360m", dev)
    be = LocalBackend(cfg, params, max_batch=2, max_len=MAX_LEN, device=dev)
    toks, lens = np.array([[3], [4]]), np.array([5, 9])
    old = be.init_contiguous_cache()
    got_old = be.decode(old, toks, lens)[0].clone()
    assert be.graph_stats.captured == 1
    new = be.init_contiguous_cache()
    got_new = be.decode(new, toks, lens)[0].clone()
    assert be.graph_stats.captured == 2
    assert torch.equal(got_old, got_new)          # both caches were zeros
    for c_old, c_new in zip(old, new):
        for name in c_old:
            assert torch.equal(c_old[name], c_new[name])
    be.decode(new, toks, lens)
    assert be.graph_stats.captured == 2           # a hit


@pytest.mark.parametrize("paged", [False, True])
def test_split_decode_under_capture(dev, paged):
    """At max_len 256 the decode kernels split each row over two runs of
    positions, with a workspace and arrival counters; replays (three, with
    other lengths) give the bits of the fused plan (the same kernels, one
    graph a segment)."""
    cfg, params = _model("smollm-360m", dev)
    max_len, b, bs = 256, 2, 16
    assert split_plan(max_len, b, cfg.n_kv_heads)[0] > 1
    gen = torch.Generator(device=dev).manual_seed(3)
    outs = {}
    for plan in ("fused", "jit"):
        be = LocalBackend(cfg, params, max_batch=b, max_len=max_len,
                          plan=plan, device=dev)
        if paged:
            cache = make_paged_cache(cfg, b * max_len // bs, bs, device=dev)
            bt = np.arange(b * max_len // bs).reshape(b, -1)[:, ::-1].copy()
        else:
            cache = be.init_contiguous_cache()
        for c in cache:
            for t in c.values():
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        got = []
        for lens in ([150, 255], [200, 131], [254, 140]):
            toks = np.array([[lens[0] % 97], [lens[1] % 89]])
            if paged:
                lg = be.paged_decode(cache, toks, np.array(lens), bt)[0]
            else:
                lg = be.decode(cache, toks, np.array(lens))[0]
            got.append(lg.clone())
        outs[plan] = got
        gen.manual_seed(3)
    for a, b_ in zip(outs["jit"], outs["fused"]):
        assert torch.equal(a, b_)


def test_failed_capture_raises(dev):
    """A body that reads the device on the host cannot be captured: the
    call raises, keeps no graph, and never runs the body eagerly instead."""
    cfg, params = _model("smollm-360m", dev)
    be = LocalBackend(cfg, params, max_batch=2, max_len=MAX_LEN, device=dev)
    decode = be._bodies.decode

    def host_read(p, cache, tokens, lengths):
        tokens.cpu()
        return decode(p, cache, tokens, lengths)

    be._bodies = be._bodies._replace(decode=host_read)
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError):
        be.decode(be.init_contiguous_cache(), np.array([[1], [2]]),
                  np.array([3, 4]))
    torch.cuda.synchronize()
    assert not be._graphs and be.graph_stats.captured == 0
    # the warm-up launched once; the failed capture recorded nothing
    L = cfg.n_layers
    after = kernels.launch_counts()
    assert after["decode_attention"] - before["decode_attention"] == L


@pytest.mark.parametrize("plan", ["chain", "fused"])
@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b"])
def test_plan_replays_its_direct_output(dev, arch, plan):
    """A launch plan of the decode body, captured one CUDA graph a segment
    and replayed, against the same plan dispatched directly: the same
    logits and the same cache, bit for bit (the RWKV state restored
    before each run); the executor's recorder gets a span a segment."""
    cfg, params = _model(arch, dev)
    cache = make_cache(cfg, 2, MAX_LEN, device=dev)
    leaves = [t for layer in cache for t in layer.values()]
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in leaves:
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.1)
    saved = [t.clone() for t in leaves]
    body = make_step_bodies(cfg).decode
    toks = torch.tensor([[3], [5]], device=dev)
    lens = torch.tensor([4, 9], dtype=torch.int32, device=dev)
    tr = trace_fn(lambda p, c, t, n: body(p, c, t, n)[0], params, cache,
                  toks, lens)
    planner = Planner(tr, "Intel+H100")
    lp = planner.chain(8) if plan == "chain" else planner.fused_rules()
    assert lp.n_launches < len(tr.kernels)
    ex = PlanExecutor(tr, lp)
    flat = tr.flat_inputs(params, cache, toks, lens)

    def restore():
        for t, s in zip(leaves, saved):
            t.copy_(s)

    want = ex.run_flat(flat)[0][0].clone()
    want_cache = [t.clone() for t in leaves]
    restore()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        ex.run_flat(flat)                       # warm-up outside capture
    torch.cuda.synchronize()
    restore()
    prog = ex.capture(flat, stream)
    torch.cuda.synchronize()
    ex.recorder = SpanRecorder()
    for i in range(2):
        restore()
        host = []
        got = ex.replay(prog, host)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(leaves, want_cache))
        # one dispatch span a segment's replay (or direct views segment)
        spans = ex.recorder.spans[i * len(host):]
        assert len(host) == lp.n_launches == len(spans)
        assert [s.args["segment"] for s in spans] == list(range(len(host)))
