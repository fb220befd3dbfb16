"""The engine's flat, typed op program — what ``lower()`` emits.

Port of ``repro/engine/program.py`` (pure Python, copied).

A program is a topologically-ordered tuple of ops over SSA-style value ids:
value 0 is the network input, each op reads its ``src`` id(s) and defines
``out``.  All geometries (channels, spatial extents, FC fan-in) are resolved
statically at lowering time, so executing a program never inspects shapes or
re-walks the nested spec.

``ConvOp`` carries the fused epilogue: ``fuse_relu`` marks a ``Conv → ReLU``
chain collapsed at lowering time, and ``res`` names the shortcut value of a
bottleneck tail (``Conv → (+shortcut) → ReLU``), so the executor can hand
the whole chain to a conv kernel's in-kernel epilogue and write the
output once from the f32 accumulator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.engine import spec


@dataclasses.dataclass(frozen=True)
class ConvOp:
    """One convolution with its statically-resolved geometry + epilogue.

    c/h/w: input channels and spatial dims; m/k/stride/pad: filter bank;
    e/f: output spatial dims.  The bias add is always part of the op (every
    conv layer carries a bias); ``fuse_relu``/``res`` extend the epilogue.
    """

    name: str
    src: int
    out: int
    c: int
    h: int
    w: int
    m: int
    k: int
    stride: int
    pad: int
    sparsity: float
    e: int
    f: int
    fuse_relu: bool = False
    res: Optional[int] = None     # shortcut value id added before the ReLU


@dataclasses.dataclass(frozen=True)
class PoolOp:
    kind: str                     # max | avg | gap
    k: int
    stride: int
    pad: int
    src: int
    out: int
    e: int
    f: int


@dataclasses.dataclass(frozen=True)
class FCOp:
    """Fully-connected layer with its fan-in resolved at lowering time.

    ``in_f`` is the static flattened input dim — FC weights are created at
    engine *bind* time from this, never lazily inside a trace.
    """

    name: str
    src: int
    out: int
    in_f: int
    out_f: int


@dataclasses.dataclass(frozen=True)
class ConcatOp:
    srcs: Tuple[int, ...]
    out: int


@dataclasses.dataclass(frozen=True)
class ResidualAddOp:
    """Shortcut add that could not be fused into a conv (body not ending in
    a Conv); ``a`` is the body output, ``b`` the shortcut."""

    a: int
    b: int
    out: int
    fuse_relu: bool = False


@dataclasses.dataclass(frozen=True)
class ReluOp:
    """A ReLU that did not fuse into a preceding conv (e.g. after an FC)."""

    src: int
    out: int


OpT = Any  # union of the op dataclasses above


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered network: flat ops + the spec-order conv table.

    ``conv_table`` lists ``(Conv spec, (C, H, W) input shape)`` in the same
    order the historical spec walkers visited convs (Residual: body then
    proj) — it drives parameter init and the benchmark shape tables, while
    ``ops`` is the (topological) execution order.
    """

    ops: Tuple[OpT, ...]
    out: int
    in_shape: Tuple[int, int, int]
    conv_table: Tuple[Tuple[spec.Conv, Tuple[int, int, int]], ...]

    @property
    def conv_ops(self) -> Tuple[ConvOp, ...]:
        return tuple(op for op in self.ops if isinstance(op, ConvOp))

    @property
    def fc_ops(self) -> Tuple[FCOp, ...]:
        return tuple(op for op in self.ops if isinstance(op, FCOp))

    def summary(self) -> str:
        counts: dict = {}
        fused = 0
        for op in self.ops:
            counts[type(op).__name__] = counts.get(type(op).__name__, 0) + 1
            if isinstance(op, ConvOp) and (op.fuse_relu or op.res is not None):
                fused += 1
        parts = [f"{k}x{v}" for k, v in sorted(counts.items())]
        return (f"{len(self.ops)} ops ({', '.join(parts)}), "
                f"{fused} convs with fused epilogue")
