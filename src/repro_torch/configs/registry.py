"""Architecture registry: ``--arch <id>`` -> ArchConfig (full or smoke).

The same ten names as ``repro/configs/registry.py``: the dense, MoE,
VLM, SSM and hybrid decoder families and whisper-base, the
encoder-decoder family.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "whisper-base": "repro_torch.configs.whisper_base",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()
