"""Candidate space for per-layer kernel customization (paper §3.3-3.4).

Port of ``repro/tuning/space.py`` over the card's axes.  The choices the
tuner scores:

  method      ∈ {dense, lowered, csr-direct, pallas, bsr}; ``pallas`` is the
               ELL direct sparse conv kernel, ``bsr`` the BCSR one (the
               reference's method names, so plans compare across the two
               packages)
  pad_to      ∈ ELL row-padding buckets, only where padding is work: the
               ``lowered`` and ``csr-direct`` methods walk every padded slot;
               the ELL kernel's runs stop at each row's nnz, so its
               candidates leave ``pad_to`` unset (the bank's default, 8)
  fuse        ∈ {False, True} (pallas, bsr): the epilogue (bias, ReLU,
               shortcut) in-kernel on the f32 sums, or as separate passes
  pipeline    ∈ {False, True} (pallas): the double-buffered input slabs or
               the blocking schedule
  permute     ∈ {False, True} (pallas): an nnz-balanced bank, the output
               gathered back to natural channel order
  tm          the ELL kernel's output-channel tile, one of
               ``budget.ELL_TILES``' heights that ``tile_candidates`` accepts
               at the geometry (the pixel tile is the kernel's own choice)
  (bm, bn)    ∈ ``BLOCK_CANDIDATES`` (bsr): the BCSR tile shape
  value_dtype ∈ {float32, int8, float8_e4m3fn} (pallas, bsr): the bank's
               value storage, narrow ones with a per-channel f32 scale

``te``/``tf`` stay None: the CUDA kernels pick their own pixel tile
(``resolve_schedule``, ``resolve_bsr_schedule``), and the engine's
``ExecutionReport.tiling`` shows what they chose.  Fully dense layers
(sparsity 0) only ever run dense.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.kernels.bsr_conv.ops import (BLOCK_CANDIDATES,
                                              bsr_tile_candidates)
from repro_torch.kernels.sparse_conv.ops import tile_candidates

METHODS = ("dense", "lowered", "csr-direct", "pallas", "bsr")

# Value-storage dtypes: f32 banks plus the quantised (per-output-channel
# symmetric scale, f32 sums) narrow formats.  Only the kernels (pallas,
# bsr) run narrow banks.
VALUE_DTYPES = ("float32", "int8", "float8_e4m3fn")


def allowed_value_dtypes(backend: str) -> Tuple[str, ...]:
    """The value-storage dtypes executable on ``backend``: all three on the
    card (Hopper converts e4m3, and the kernels decode it exactly); the
    reference's policy elsewhere (no fp8 off its accelerator)."""
    if backend in ("cuda", "tpu"):
        return VALUE_DTYPES
    return tuple(d for d in VALUE_DTYPES if d != "float8_e4m3fn")


# ELL K-padding buckets, the reference's.
PAD_TO_BUCKETS = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """Static description of one conv layer instance (what the cache keys
    on): m/c out/in channels, h/w the input's spatial dims, r/s the filter,
    and the epilogue the engine fused into the conv (``relu``,
    ``residual``)."""

    name: str
    m: int
    c: int
    h: int
    w: int
    r: int
    s: int
    stride: int = 1
    pad: int = 0
    sparsity: float = 0.0
    batch: int = 1
    dtype: str = "float32"
    relu: bool = False
    residual: bool = False

    @property
    def hp(self) -> int:
        return self.h + 2 * self.pad

    @property
    def wp(self) -> int:
        return self.w + 2 * self.pad

    @property
    def e(self) -> int:
        return (self.hp - self.r) // self.stride + 1

    @property
    def f(self) -> int:
        return (self.wp - self.s) // self.stride + 1

    @property
    def row_nnz_est(self) -> int:
        """Expected nonzeros per output channel at this sparsity."""
        return max(1, math.ceil(self.c * self.r * self.s
                                * (1.0 - self.sparsity)))

    def k_est(self, pad_to: int) -> int:
        """Estimated padded ELL row length K for a pad_to bucket."""
        pad_to = max(1, pad_to)
        k = self.row_nnz_est
        return max(pad_to, ((k + pad_to - 1) // pad_to) * pad_to)

    def bsr_grid(self, bm: int, bn: int) -> Tuple[int, int, int]:
        """(gbm, gbn, kept-per-row estimate) of a (bm, bn)-blocked bank,
        assuming block-structured pruning at this layer's sparsity."""
        gbm = -(-self.m // bm)
        gbn = -(-(self.c * self.r * self.s) // bn)
        kept = min(gbn, max(1, math.ceil((1.0 - self.sparsity) * gbn)))
        return gbm, gbn, kept


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the customization space (fields as in the reference;
    ``te``/``tf`` are kept for the plan schema and stay None here)."""

    method: str
    tm: Optional[int] = None
    pad_to: Optional[int] = None
    te: Optional[int] = None
    tf: Optional[int] = None
    fuse: bool = False
    pipeline: bool = False
    permute: bool = False
    block_m: Optional[int] = None
    block_n: Optional[int] = None
    value_dtype: str = "float32"

    def to_dict(self) -> dict:
        return {"method": self.method, "tm": self.tm, "pad_to": self.pad_to,
                "te": self.te, "tf": self.tf, "fuse": self.fuse,
                "pipeline": self.pipeline, "permute": self.permute,
                "block_m": self.block_m, "block_n": self.block_n,
                "value_dtype": self.value_dtype}

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        return cls(method=d["method"], tm=d.get("tm"), pad_to=d.get("pad_to"),
                   te=d.get("te"), tf=d.get("tf"),
                   fuse=bool(d.get("fuse", False)),
                   pipeline=bool(d.get("pipeline", False)),
                   permute=bool(d.get("permute", False)),
                   block_m=d.get("block_m"), block_n=d.get("block_n"),
                   value_dtype=d.get("value_dtype", "float32"))


def ell_tiles(g: ConvGeometry, pipeline: Optional[bool] = None
              ) -> List[Tuple[int, int]]:
    """The ELL kernel's ``(tm, tp)`` tiles at this geometry
    (``kernels.sparse_conv.ops.tile_candidates``)."""
    return tile_candidates(g.m, g.k_est(8), g.e, g.f, n=g.batch, c=g.c,
                           r=g.r, s=g.s, stride=g.stride, hp=g.hp, wp=g.wp,
                           pipeline=pipeline, itemsize=_itemsize(g))


def ell_tms(g: ConvGeometry) -> List[int]:
    """The distinct channel tiles ``tm`` the ELL kernel takes here, in its
    order of preference."""
    out: List[int] = []
    for tm, _ in ell_tiles(g):
        if tm not in out:
            out.append(tm)
    return out


def pallas_feasible(g: ConvGeometry, k: Optional[int] = None,
                    value_dtype: str = "float32") -> bool:
    """The ELL kernel has a schedule at this geometry (its slab stages fit
    a block's shared memory; the value dtype changes nothing there)."""
    return bool(ell_tiles(g))


def bsr_feasible(g: ConvGeometry, bm: int, bn: int,
                 value_dtype: str = "float32") -> bool:
    """The BCSR kernel takes a (bm, bn) block here: a tile holding whole
    block-rows whose stages fit a block's shared memory."""
    return bool(_bsr_tiles(g, bm, bn, value_dtype))


def _bsr_tiles(g: ConvGeometry, bm: int, bn: int, value_dtype: str):
    gbm, _, _ = g.bsr_grid(bm, bn)
    return bsr_tile_candidates(bm, bn, g.e, g.f, n=g.batch, m=gbm * bm,
                               crs=g.c * g.r * g.s, value_dtype=value_dtype,
                               itemsize=_itemsize(g))


def _itemsize(g: ConvGeometry) -> int:
    """Bytes an activation element of the geometry takes: the kernels'
    stages are in the activation's dtype."""
    return 2 if g.dtype in ("bfloat16", "float16") else 4


def enumerate_candidates(g: ConvGeometry,
                         methods: Tuple[str, ...] = METHODS,
                         value_dtypes: Tuple[str, ...] = ("float32",),
                         ) -> List[Candidate]:
    """All statically valid customization points for one layer.

    ``bsr``: every block shape the kernel takes at this geometry, each
    unfused and fused, for each value dtype.  ``lowered``/``csr-direct``:
    one per ``pad_to`` bucket.  ``pallas``: every channel tile ``tm`` the
    ELL kernel takes here x fuse x pipeline (pipelined first: on ties it
    is never worse; a 1x1 conv has only the blocking one) x permute, for
    each value dtype.  ``value_dtypes``
    defaults to f32 only: narrow storage is lossy, so quantised candidates
    enter only when a caller opts in (``plan_layer(..., quantize=True)``).
    """
    if g.sparsity <= 0.0:
        return [Candidate("dense")]
    out: List[Candidate] = []
    if "dense" in methods:
        out.append(Candidate("dense"))
    if "bsr" in methods:
        for vdt in value_dtypes:
            for bm, bn in BLOCK_CANDIDATES:
                if not bsr_feasible(g, bm, bn, vdt):
                    continue
                for fuse in (False, True):
                    out.append(Candidate("bsr", fuse=fuse, block_m=bm,
                                         block_n=bn, value_dtype=vdt))
    for pad_to in PAD_TO_BUCKETS:
        if "lowered" in methods:
            out.append(Candidate("lowered", pad_to=pad_to))
        if "csr-direct" in methods:
            out.append(Candidate("csr-direct", pad_to=pad_to))
    if "pallas" in methods:
        tms = ell_tms(g)
        # a 1x1 conv stages nothing: its kernel has one (blocking) schedule
        pipes = (False,) if g.r == g.s == 1 else (True, False)
        for vdt in value_dtypes:
            for fuse in (False, True):
                for pipe in pipes:
                    for tm in tms:
                        for permute in (False, True):
                            out.append(Candidate(
                                "pallas", tm=tm, fuse=fuse, pipeline=pipe,
                                permute=permute, value_dtype=vdt))
    return out
