from repro_torch.configs.registry import (
    ARCH_IDS,
    all_configs,
    get_config,
    get_smoke_config,
)

__all__ = ["ARCH_IDS", "all_configs", "get_config", "get_smoke_config"]
