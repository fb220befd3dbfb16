"""Architecture registry: ``--arch <id>`` resolution for the port's launcher
and tests.

Port of ``repro/configs/__init__.py`` for the dense-attention archs the port
runs (each config module is a copy of the reference's).  The reference's
other archs (MLA, MoE, Mamba2, hybrid, encoder, VLM) are known by name and
raise until a later slice ports their layers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = (
    "qwen1_5_0_5b",
    "qwen1_5_4b",
    "mistral_large_123b",
    "yi_9b",
)
# Archs of the reference whose layers (MLA, MoE, Mamba2) the port lacks.
LATER = ("deepseek-v3-671b", "olmoe-1b-7b", "jamba-1.5-large-398b",
         "hubert-xlarge", "mamba2-2.7b", "phi-3-vision-4.2b")

REGISTRY: Dict[str, object] = {}
for _m in _MODULES:
    mod = importlib.import_module(f"repro_torch.configs.{_m}")
    REGISTRY[mod.ARCH_ID] = mod


def list_archs() -> List[str]:
    return list(REGISTRY.keys())


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch in LATER:
        raise NotImplementedError(
            f"arch {arch!r} waits for a later slice of the port; the port "
            f"runs {list_archs()}")
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = REGISTRY[arch]
    return mod.smoke() if smoke else mod.full()
