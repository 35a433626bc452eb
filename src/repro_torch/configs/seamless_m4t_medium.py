"""SeamlessM4T-medium backbone — encoder-decoder transformer
[arXiv:2308.11596].  The speech/text frontend is a STUB: the caller passes
precomputed frame embeddings (``forward(encoder_tokens=...)``,
``n_frontend_tokens`` x ``d_model``)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                 # decoder depth
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    block_pattern=("attn",),
    act="gelu",
    glu=False,
    frontend="audio_frames",
    n_frontend_tokens=4096,      # encoder frame-embedding length (stub)
))
