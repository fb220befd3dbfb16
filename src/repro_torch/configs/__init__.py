"""Architecture registry: ``--arch <id>`` resolution for the port's launcher
and tests.

Port of ``repro/configs/__init__.py``: the same ten archs in the same
order, each config module a copy of the reference's (dense GQA, MoE, MLA,
Mamba2, the Mamba2/attention hybrid, the encoder and the VLM backbone),
with its ``FAMILY`` and ``SHAPES`` (the applicable input-shape cells), and
the registry functions the dry run walks.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterator, List, Tuple

from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig

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

SHAPE_BY_NAME = {s.name: s for s in ALL_SHAPES}


def list_archs() -> List[str]:
    return list(REGISTRY.keys())


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = REGISTRY[arch]
    return mod.smoke() if smoke else mod.full()


def applicable_shapes(arch: str) -> List[ShapeConfig]:
    return [SHAPE_BY_NAME[n] for n in REGISTRY[arch].SHAPES]


def skipped_shapes(arch: str) -> List[Tuple[str, str]]:
    """(shape, reason) for every cell the reference's table skips."""
    mod = REGISTRY[arch]
    out = []
    for s in ALL_SHAPES:
        if s.name in mod.SHAPES:
            continue
        if mod.FAMILY == "encoder":
            out.append((s.name, "encoder-only: no decode step"))
        else:
            out.append((s.name, "full attention: O(T^2), long_500k skipped"))
    return out


def all_cells(*, include_skipped: bool = False
              ) -> Iterator[Tuple[str, ShapeConfig]]:
    """Iterate (arch, shape) cells in registry order."""
    for arch in list_archs():
        for s in applicable_shapes(arch):
            yield arch, s
        if include_skipped:
            for name, _ in skipped_shapes(arch):
                yield arch, SHAPE_BY_NAME[name]
