"""Architecture registry: ``--arch <id>`` -> ArchConfig (full or smoke).

The same ten names as ``repro/configs/registry.py``.  The port runs the
dense, MoE and VLM decoder families so far; an arch of another family
raises ``NotImplementedError`` naming the port that brings it.
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
    "mamba2-2.7b": None,
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "zamba2-1.2b": None,
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "whisper-base": None,
}

# archs whose family the port does not run yet -> the port that brings it
_LATER = {
    "mamba2-2.7b": "the port of the SSM family (mamba2.py, ssd_scan)",
    "zamba2-1.2b": "the port of the SSM family (mamba2.py, the hybrid stack, ssd_scan)",
    "whisper-base": "the port of the encoder-decoder family (encdec.py)",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list_archs()}")
    if _ARCH_MODULES[arch] is None:
        raise NotImplementedError(
            f"{arch} is not ported yet: it comes with {_LATER[arch]}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()
