"""Architecture registry — importing this package registers the configs.

Every architecture of the reference's registry is registered here too.
"""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, MambaConfig, ModelConfig, MoEConfig, ShapeSpec,
    applicable_shapes, get_config, list_configs, reduced, register,
    torch_dtype,
)
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b, gemma2_27b, internlm2_20b, jamba_15_large_398b,
    kimi_k2_1t_a32b, llama32_vision_11b, moonshot_v1_16b_a3b,
    paper_workloads, rwkv6_3b, seamless_m4t_medium, smollm_360m,
)

# assigned architectures
ASSIGNED = (
    "internlm2-20b",
    "codeqwen1.5-7b",
    "smollm-360m",
    "gemma2-27b",
    "moonshot-v1-16b-a3b",
    "kimi-k2-1t-a32b",
    "seamless-m4t-medium",
    "rwkv6-3b",
    "jamba-1.5-large-398b",
    "llama-3.2-vision-11b",
)

# the paper's own workloads (Table III)
PAPER_WORKLOADS = (
    "bert-base-uncased",
    "xlm-roberta-base",
    "gpt2",
    "llama-3.2-1b",
)
