"""Llama-3.2-Vision-11B backbone — self-attn decoder with interleaved
cross-attention image layers (every 5th layer) [hf:meta-llama/Llama-3.2-11B-Vision].

Vision frontend is a STUB: the caller passes precomputed patch embeddings
(``forward(frontend_embeds=...)``, ``n_frontend_tokens`` x ``d_model``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    frontend="vision_patches",
    n_frontend_tokens=1601,      # 1 tile x (40x40 patches + cls)
))
