"""Moonlight-16B-A3B (kimi/moonshot) — MoE 64 experts top-6, 2 shared
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    block_pattern=("attn",),
    moe_slots=(0,),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared_experts=2),
))
