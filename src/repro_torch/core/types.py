"""Shared dataclasses for the sparsity subsystem (copy of
``repro/core/types.py``).

Escoin/Escort turns weight pruning into inference speed.  Everything the
framework does with sparsity is driven by a single ``SparsityConfig`` that is
threaded from the arch config down to the individual linear / conv call sites.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Sparse execution methods.
#   dense       : zero-filled dense weights, XLA native ops  (CUBLAS analogue)
#   lowered     : im2col + CSR SpMM                           (CUSPARSE analogue)
#   csr-direct  : the paper's direct sparse convolution / ELL sparse matmul
#   bcsr-mxu    : beyond-paper block-sparse path that feeds the TPU MXU
METHODS = ("dense", "lowered", "csr-direct", "bcsr-mxu")


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """How a weight tensor is pruned and executed.

    Attributes:
      sparsity: fraction of weights that are zero (paper: typically >= 0.8).
      method:   one of ``METHODS``.
      block:    (bm, bn) tile size for the ``bcsr-mxu`` path.  Tiles are scored
                by L2 norm and pruned whole, so surviving tiles are dense and
                MXU-friendly.  128x128 aligns with the systolic array; smaller
                blocks trade MXU utilisation for pruning flexibility.
      enabled:  master switch; ``False`` means the layer runs dense regardless.
    """

    sparsity: float = 0.0
    method: str = "dense"
    block: Tuple[int, int] = (128, 128)
    enabled: bool = False

    def __post_init__(self) -> None:
        if self.method not in METHODS:
            raise ValueError(f"unknown sparsity method {self.method!r}; choose from {METHODS}")
        if not (0.0 <= self.sparsity < 1.0):
            raise ValueError(f"sparsity must be in [0, 1), got {self.sparsity}")

    @property
    def density(self) -> float:
        return 1.0 - self.sparsity


DENSE = SparsityConfig()


def escoin(sparsity: float = 0.9, method: str = "csr-direct",
           block: Tuple[int, int] = (128, 128)) -> SparsityConfig:
    """Convenience constructor for an enabled sparsity config."""
    return SparsityConfig(sparsity=sparsity, method=method, block=block, enabled=True)
