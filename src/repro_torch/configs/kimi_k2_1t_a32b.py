"""Kimi K2 — trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2; paper-table, unverified]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    block_pattern=("attn",),
    moe_slots=(0,),
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared_experts=1,
                  capacity_factor=1.0, dispatch_chunks=4),
))
