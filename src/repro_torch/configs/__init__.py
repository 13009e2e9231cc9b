from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, check_supported, get_config, list_configs, register,
)
from repro_torch.configs import registry as _registry  # noqa: F401  (populates the registry)
