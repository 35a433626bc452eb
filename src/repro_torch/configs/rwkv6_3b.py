"""RWKV6 (Finch) 3B: attention-free, data-dependent decay [arXiv:2404.05892].

Sub-quadratic: decode carries an O(1)-per-token recurrent state per layer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                  # wkv head size 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    subquadratic=True,
    glu=False,                   # rwkv channel-mix is its own shape
))
