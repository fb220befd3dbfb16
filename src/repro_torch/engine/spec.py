"""Layer-spec vocabulary for the paper's CNN benchmark models.

Port of ``repro/engine/spec.py`` (pure Python, copied).

These frozen dataclasses are the *source language* of the compile-once
engine: ``repro_torch.models.cnn`` builds AlexNet/GoogLeNet/ResNet-50 tables out
of them, and ``repro_torch.engine.lower`` is the only code that ever walks a
nested spec — everything downstream (init, forward, shape tables, the
autotuner) consumes the flat lowered program instead.

They live here (not in ``models/cnn.py``) so the engine does not import the
model zoo; ``models/cnn.py`` re-exports them under their historical names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    out_c: int
    k: int
    stride: int = 1
    pad: int = 0
    sparsity: float = 0.85   # 0.0 => layer kept dense (runs dense always)


@dataclasses.dataclass(frozen=True)
class Pool:
    kind: str                # max | avg | gap
    k: int = 3
    stride: int = 2
    pad: int = 0


@dataclasses.dataclass(frozen=True)
class FC:
    name: str
    out_f: int
    sparsity: float = 0.9


@dataclasses.dataclass(frozen=True)
class Concat:
    """Inception module: parallel branches concatenated on channels."""
    branches: Tuple[Tuple[Any, ...], ...]


@dataclasses.dataclass(frozen=True)
class Residual:
    """ResNet bottleneck: body branch + (optional projection) shortcut."""
    body: Tuple[Any, ...]
    proj: Optional[Conv] = None


@dataclasses.dataclass(frozen=True)
class Relu:
    pass
