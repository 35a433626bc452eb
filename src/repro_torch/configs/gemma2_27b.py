"""Gemma2-27B — local/global alternating attention, logit softcaps
[arXiv:2408.00118].  head_dim=128 (d_model/n_heads=144 is NOT the head dim
for gemma2-27b; it uses 32 heads x 128).

``attn_scale`` is the reference's 0.0625 = 256^-0.5; the published
query_pre_attn_scalar is d/h = 144, a scale of 0.0833 (ROADMAP Queue C).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    block_pattern=("attn_local", "attn"),   # alternating local/global
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu",
    attn_scale=0.06250,
))
