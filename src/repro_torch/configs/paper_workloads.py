"""The paper's own four benchmark workloads (Table III).

Own copies of ``repro/configs/paper_workloads.py``, field for field.
BERT/XLM-R are encoder-only (non-causal attention); GPT2 / Llama-3.2-1B are
decoders.  As in the reference, all four are modelled with RMSNorm, RoPE
and no biases, and Llama-3.2-1B without its rope_scaling (ROADMAP Queue C
lists these differences from the published models).
"""
from repro_torch.configs.base import ModelConfig, register

BERT_BASE = register(ModelConfig(
    name="bert-base-uncased",
    family="encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    act="gelu",
    glu=False,
))

XLM_ROBERTA = register(ModelConfig(
    name="xlm-roberta-base",
    family="encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=250002,
    act="gelu",
    glu=False,
))

GPT2 = register(ModelConfig(
    name="gpt2",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50257,
    act="gelu",
    glu=False,
))

LLAMA_32_1B = register(ModelConfig(
    name="llama-3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
))
