"""The fused launch plan on the paper's workloads and the remaining dense
decoders, on reduced configs in f32 on the CPU.

Under ``plan="fused"`` each decoder's every traced call (a slot's prefill,
a decode step) finds the reference's norm windows: L ``rmsnorm_matmul``
(a q bias is added after the window, which ends at the product), L
``residual_rmsnorm`` and the final norm; and its tokens equal the
``plan="jit"`` engine's.  The encoders serve the same way.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.models import init_params

torch.set_num_threads(2)
NAMES = ("llama-3.2-1b", "gpt2", "internlm2-20b", "codeqwen1.5-7b",
         "gemma2-27b", "bert-base-uncased", "xlm-roberta-base")


def _requests(vocab):
    rng = np.random.default_rng(3)
    return [Request(i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                    max_new_tokens=m)
            for i, (n, m) in enumerate(((5, 4), (11, 6), (7, 3)))]


def _params(cfg):
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    for blk in params["blocks"]:     # a bias the zero init would hide
        for b in ("bq", "bk", "bv"):
            if b in blk["mixer"]:
                blk["mixer"][b].normal_(0.0, 0.5, generator=torch.Generator()
                                        .manual_seed(1))
    return params


@pytest.mark.parametrize("name", NAMES)
def test_fused_plan_hits_every_norm_window(name):
    cfg = reduced(get_config(name))
    params = _params(cfg)
    kw = dict(max_batch=2, max_len=32, device="cpu")
    jit = ServeEngine(cfg, params, plan="jit", **kw).run(
        _requests(cfg.vocab_size))
    eng = ServeEngine(cfg, params, plan="fused", **kw)
    done = eng.run(_requests(cfg.vocab_size))
    assert [r.generated for r in done] == [r.generated for r in jit]
    L = cfg.n_layers
    fns = list(eng.backend._planned_fns.values())
    assert len(fns) == 4          # a prefill per prompt length, the decode
    for pf in fns:
        hits = {n: pf.rule_names.count(n) for n in set(pf.rule_names)}
        assert hits == {"rmsnorm_matmul": L, "residual_rmsnorm": L,
                        "rmsnorm": 1}, hits
