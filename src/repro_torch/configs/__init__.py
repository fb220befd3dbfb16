"""Architecture registry: ``--arch <id>`` resolution for the port's launcher
and tests.

Port of ``repro/configs/__init__.py``: the same ten archs in the same
order, each config module a copy of the reference's (dense GQA, MoE, MLA,
Mamba2, the Mamba2/attention hybrid, the encoder and the VLM backbone).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = (
    "deepseek_v3_671b",
    "olmoe_1b_7b",
    "jamba_1_5_large_398b",
    "qwen1_5_0_5b",
    "qwen1_5_4b",
    "mistral_large_123b",
    "yi_9b",
    "hubert_xlarge",
    "mamba2_2_7b",
    "phi_3_vision_4_2b",
)

REGISTRY: Dict[str, object] = {}
for _m in _MODULES:
    mod = importlib.import_module(f"repro_torch.configs.{_m}")
    REGISTRY[mod.ARCH_ID] = mod


def list_archs() -> List[str]:
    return list(REGISTRY.keys())


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = REGISTRY[arch]
    return mod.smoke() if smoke else mod.full()
