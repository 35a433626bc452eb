"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  Each 8-layer Jamba block: attention at slot 4, Mamba
elsewhere; MoE MLP every other layer (odd slots).

Sub-quadratic-ish: attention layers are 1/8 of the stack and decode is linear
in KV length.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_slots=(1, 3, 5, 7),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, capacity_factor=1.25,
                  dispatch_chunks=4),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
))
