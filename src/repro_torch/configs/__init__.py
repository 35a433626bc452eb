"""Architecture registry — importing this package registers the configs.

Only the architectures the port serves are registered; the others join as
their block kinds are ported (ROADMAP Queue A).
"""
from repro_torch.configs.base import (  # noqa: F401
    MambaConfig, ModelConfig, MoEConfig, get_config, list_configs, reduced,
    register, torch_dtype,
)
from repro_torch.configs import rwkv6_3b, smollm_360m  # noqa: F401
