"""Architecture registry — importing this package registers the configs.

Only the architectures the port serves are registered; the others join as
their block kinds are ported (ROADMAP Queue A).
"""
from repro_torch.configs.base import (  # noqa: F401
    MambaConfig, ModelConfig, MoEConfig, get_config, list_configs, reduced,
    register, torch_dtype,
)
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b, gemma2_27b, internlm2_20b, paper_workloads, rwkv6_3b,
    smollm_360m,
)

# the paper's own workloads (Table III)
PAPER_WORKLOADS = (
    "bert-base-uncased",
    "xlm-roberta-base",
    "gpt2",
    "llama-3.2-1b",
)
