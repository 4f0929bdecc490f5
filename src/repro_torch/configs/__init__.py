"""Architecture and input-shape configs (pure data)."""
from repro_torch.configs.base import (
    ArchConfig,
    AttnConfig,
    MoEConfig,
    SSMConfig,
    InputShape,
    INPUT_SHAPES,
)
from repro_torch.configs.registry import get_config, list_archs, smoke_config
