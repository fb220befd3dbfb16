"""Compressed sparse formats with the paper's *weight stretching* preprocessing.

Port of ``repro/core/sparse_format.py``.  Three formats:

``EllConv``   -- the paper's stretched-CSR conv weights, padded per row to a
                 rectangular (ELL) layout.  Each output channel m keeps
                 K = max-row-nnz entries of (value, c, r, s).  Padding entries
                 carry value 0 and index 0, so they are inert.
``EllMatrix`` -- the same idea for 2-D weights (the ``lowered`` method's
                 SpMM); each row keeps K column indices + values.
``BcsrMatrix``/``BcsrConv`` -- block compressed sparse row: per block-row, a
                 padded list of kept block-column ids plus the dense tiles.
                 Padding tiles point at block-column 0 with all-zero data.

The conv formats (``EllConv``/``BcsrConv``) also carry *quantised value
streams* (:func:`quantize_values` / :func:`dequantize`): the nonzero values
stored int8 or fp8 (``float8_e4m3fn``) with one f32 symmetric scale per
output channel, the reference's construction bit for bit.

Every array is built exactly as the JAX package builds it (the same nonzero
order, the same padding rules): on the host in numpy and then moved to the
requested device once, or, for ``bcsr_from_dense`` given a tensor, on that
tensor's device (the transformer's weights are pruned and blocked on the
card, one matrix at a time).  From the same dense weights the arrays are
bit-identical to the reference's, on either path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of a dtype: ``torch.float32`` -> "float32"."""
    return str(dtype).replace("torch.", "")


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))


def _row_positions(rows: np.ndarray, m: int) -> np.ndarray:
    """Position of each entry within its row, for entries grouped by row
    in ascending order (the order ``np.nonzero`` returns)."""
    counts = np.bincount(rows, minlength=m)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    return np.arange(rows.size) - starts[rows]


# ---------------------------------------------------------------------------
# ELL conv format (paper's stretched CSR, rectangularised)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EllConv:
    """Sparse conv weights for a (M, C, R, S) filter bank.

    value: (M, K) f32; cidx/ridx/sidx: (M, K) int32 input-channel, filter-row
    and filter-column of each nonzero; offset: (M, K) int32, kept zero as in
    the reference (the kernels stretch offsets themselves); nnz: (M,) int32
    true row lengths; perm: optional (M,) int32 row permutation of an
    nnz-balanced bank (row i is original channel ``perm[i]``); scale:
    optional (M,) f32 per-output-channel scales of a quantised bank
    (``quantize_values``), whose ``value`` is then int8 or float8_e4m3fn,
    the semantic weight ``value.float() * scale[m]``.
    """

    value: torch.Tensor
    cidx: torch.Tensor
    ridx: torch.Tensor
    sidx: torch.Tensor
    offset: torch.Tensor
    nnz: torch.Tensor
    shape: Tuple[int, int, int, int]
    perm: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None

    @property
    def k(self) -> int:
        return int(self.value.shape[1])

    @property
    def value_dtype(self) -> str:
        """Storage dtype name of the values ("float32", "int8",
        "float8_e4m3fn")."""
        return dtype_name(self.value.dtype)


def ell_from_dense_conv(w, pad_to: int = 8, balance: bool = False,
                        device="cuda") -> EllConv:
    """Convert a dense (M, C, R, S) filter bank to ``EllConv``.

    Each row keeps its nonzeros in (c, r, s) row-major order, K is rounded
    up to a multiple of ``pad_to`` and clamped to ``K >= pad_to >= 1``.
    ``balance=True`` also sorts the rows by nnz (``balance_ell_conv``).
    """
    w = np.asarray(w)
    m, c, r, s = w.shape
    if m == 0:
        raise ValueError("ell_from_dense_conv needs at least one output channel")
    pad_to = max(1, int(pad_to))
    flat = w.reshape(m, c * r * s)
    rows, cols = np.nonzero(flat)
    nnz = np.bincount(rows, minlength=m).astype(np.int32)
    k = max(1, int(nnz.max()))
    k = max(pad_to, ((k + pad_to - 1) // pad_to) * pad_to)
    pos = _row_positions(rows, m)
    val = np.zeros((m, k), dtype=w.dtype)
    cid = np.zeros((m, k), dtype=np.int32)
    rid = np.zeros((m, k), dtype=np.int32)
    sid = np.zeros((m, k), dtype=np.int32)
    val[rows, pos] = flat[rows, cols]
    cid[rows, pos] = cols // (r * s)
    rid[rows, pos] = (cols // s) % r
    sid[rows, pos] = cols % s
    ell = EllConv(value=_to(val, device), cidx=_to(cid, device),
                  ridx=_to(rid, device), sidx=_to(sid, device),
                  offset=_to(np.zeros((m, k), np.int32), device),
                  nnz=_to(nnz, device), shape=(m, c, r, s))
    return balance_ell_conv(ell) if balance else ell


def balance_ell_conv(ell: EllConv) -> EllConv:
    """nnz-balanced channel packing: rows sorted by descending nnz (stable),
    the permutation carried in ``perm``; a quantised bank's scales follow
    their rows.  Per-row contents are untouched, so each row sums in the
    same order as in the natural-order bank."""
    order = torch.argsort(-ell.nnz, stable=True).to(torch.int32)
    take = lambda a: a.index_select(0, order)  # noqa: E731
    perm = take(ell.perm) if ell.perm is not None else order
    return EllConv(value=take(ell.value), cidx=take(ell.cidx),
                   ridx=take(ell.ridx), sidx=take(ell.sidx),
                   offset=take(ell.offset), nnz=take(ell.nnz),
                   shape=ell.shape, perm=perm,
                   scale=None if ell.scale is None else take(ell.scale))


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """If row i of a bank is original channel ``perm[i]``, ``out[:, inv]``
    restores natural channel order."""
    return torch.argsort(perm).to(torch.int32)


# ---------------------------------------------------------------------------
# ELL matrix format (2-D weights; CSR rectangularised)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EllMatrix:
    """Sparse (M, N) weight: per row K padded (value, column) pairs."""

    value: torch.Tensor   # (M, K)
    colidx: torch.Tensor  # (M, K) int32
    nnz: torch.Tensor     # (M,) int32
    shape: Tuple[int, int]

    @property
    def k(self) -> int:
        return int(self.value.shape[1])


def ell_from_dense(w, pad_to: int = 8, device="cuda") -> EllMatrix:
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"ell_from_dense expects 2-D, got {w.shape}")
    m, n = w.shape
    if m == 0:
        raise ValueError("ell_from_dense needs at least one row")
    pad_to = max(1, int(pad_to))
    nnz = (w != 0).sum(axis=1)
    k = max(1, int(nnz.max()))
    k = max(pad_to, ((k + pad_to - 1) // pad_to) * pad_to)
    rows, cols = np.nonzero(w)
    pos = _row_positions(rows, m)
    val = np.zeros((m, k), dtype=w.dtype)
    col = np.zeros((m, k), dtype=np.int32)
    val[rows, pos] = w[rows, cols]
    col[rows, pos] = cols
    return EllMatrix(value=_to(val, device), colidx=_to(col, device),
                     nnz=_to(nnz.astype(np.int32), device), shape=(m, n))


# ---------------------------------------------------------------------------
# BCSR (block compressed sparse row)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BcsrMatrix:
    """Block-sparse (M, N) weight.

    blocks: (gm, KB, bm, bn) padded dense tiles per block-row; blockcol:
    (gm, KB) int32 block-column ids (0 for padding); nblocks: (gm,) int32
    true tiles per block-row.
    """

    blocks: torch.Tensor
    blockcol: torch.Tensor
    nblocks: torch.Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def kb(self) -> int:
        return int(self.blocks.shape[1])


def _bcsr_arrays(w: np.ndarray, block: Tuple[int, int], pad_to: int):
    m, n = w.shape
    bm, bn = block
    pad_to = max(1, int(pad_to))
    wp = np.pad(w, ((0, (-m) % bm), (0, (-n) % bn)))
    gm, gn = wp.shape[0] // bm, wp.shape[1] // bn
    tiles = wp.reshape(gm, bm, gn, bn).transpose(0, 2, 1, 3)  # (gm, gn, bm, bn)
    keep = (tiles != 0).any(axis=(2, 3))
    counts = keep.sum(axis=1)
    kb = max(1, int(counts.max()))
    kb = ((kb + pad_to - 1) // pad_to) * pad_to
    rows, cols = np.nonzero(keep)
    pos = _row_positions(rows, gm)
    blocks = np.zeros((gm, kb, bm, bn), dtype=w.dtype)
    bcol = np.zeros((gm, kb), dtype=np.int32)
    blocks[rows, pos] = tiles[rows, cols]
    bcol[rows, pos] = cols
    return blocks, bcol, counts.astype(np.int32)


def _bcsr_tensors(w: torch.Tensor, block: Tuple[int, int], pad_to: int):
    """``_bcsr_arrays`` on ``w``'s device: the same keep rule, the same
    row-major order of kept tiles (``nonzero`` lists them as ``np.nonzero``
    does), the same KB rounding and inert padding."""
    m, n = w.shape
    bm, bn = block
    pad_to = max(1, int(pad_to))
    wp = torch.nn.functional.pad(w, (0, (-n) % bn, 0, (-m) % bm))
    gm, gn = wp.shape[0] // bm, wp.shape[1] // bn
    tiles = wp.reshape(gm, bm, gn, bn).permute(0, 2, 1, 3)  # (gm, gn, bm, bn)
    keep = (tiles != 0).any(dim=3).any(dim=2)
    counts = keep.sum(dim=1)
    kb = max(1, int(counts.max()))
    kb = ((kb + pad_to - 1) // pad_to) * pad_to
    rows, cols = keep.nonzero(as_tuple=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows.numel(), device=w.device) - starts[rows]
    blocks = torch.zeros((gm, kb, bm, bn), dtype=w.dtype, device=w.device)
    bcol = torch.zeros((gm, kb), dtype=torch.int32, device=w.device)
    blocks[rows, pos] = tiles[rows, cols]
    bcol[rows, pos] = cols.to(torch.int32)
    return blocks, bcol, counts.to(torch.int32)


def bcsr_from_dense(w, block: Tuple[int, int] = (128, 128), pad_to: int = 1,
                    device=None) -> BcsrMatrix:
    """Convert a dense matrix to BCSR: a tile is kept iff it holds any
    nonzero; rows are padded to a common tile count KB (rounded up to
    ``pad_to``, at least 1) with inert all-zero tiles at block-column 0.

    A numpy ``w`` is blocked on the host and moved to ``device`` (default
    the card); a tensor is blocked on its own device, and the result moved
    to ``device`` when one is given.
    """
    block = tuple(block)
    if isinstance(w, torch.Tensor):
        arrays = _bcsr_tensors(w, block, pad_to)
        if device is not None:
            dev = resolve_device(device)
            arrays = tuple(a.to(dev) for a in arrays)
        blocks, bcol, nblocks = arrays
    else:
        w = np.asarray(w)
        dev = "cuda" if device is None else device
        blocks, bcol, nblocks = (_to(a, dev)
                                 for a in _bcsr_arrays(w, block, pad_to))
    return BcsrMatrix(blocks=blocks, blockcol=bcol, nblocks=nblocks,
                      shape=tuple(w.shape), block=block)


def bcsr_stack_from_dense(w3d, block: Tuple[int, int] = (128, 128),
                          device=None) -> BcsrMatrix:
    """Convert a stacked (L, M, N) weight to a stacked BCSR (leading L on
    every leaf), rows padded to the largest tile count over the layers, as
    the reference stores the weights of its scanned layer stack.  Slicing
    the leading axis of each leaf gives one layer's ``BcsrMatrix``."""
    per_layer = [bcsr_from_dense(w, block, device=device) for w in w3d]
    kb = max(b.kb for b in per_layer)
    pad = lambda a, k: torch.nn.functional.pad(  # noqa: E731
        a, (0, 0) * (a.ndim - 2) + (0, k))
    return BcsrMatrix(
        blocks=torch.stack([pad(b.blocks, kb - b.kb) for b in per_layer]),
        blockcol=torch.stack([pad(b.blockcol, kb - b.kb) for b in per_layer]),
        nblocks=torch.stack([b.nblocks for b in per_layer]),
        shape=per_layer[0].shape, block=tuple(block))


def block_column_fault(blockcol: torch.Tensor, nblocks: torch.Tensor,
                       ncols: int, *, ascending: bool = True
                       ) -> Optional[str]:
    """Why a BCSR bank's kept tiles cannot be walked, or None.

    Every block-row's ``nblocks[i]`` leading block columns must lie in
    ``[0, ncols)`` and be distinct; with ``ascending`` also strictly
    ascending (what ``bcsr_from_dense`` builds).  Runs on the tensors'
    device and reads one flag back.
    """
    gm, kb = blockcol.shape
    nb = nblocks.long()
    if gm == 0:
        return None
    if bool(((nb < 0) | (nb > kb)).any()):
        return f"nblocks outside [0, {kb}]"
    live = torch.arange(kb, device=blockcol.device)[None, :] < nb[:, None]
    cols = blockcol.long()
    if bool((live & ((cols < 0) | (cols >= ncols))).any()):
        return f"a kept tile's block column lies outside [0, {ncols})"
    if ascending:
        step = cols[:, 1:] - cols[:, :-1]
        pair = live[:, 1:]
        if bool((pair & (step == 0)).any()):
            return "two tiles of one block-row share a block column"
        if bool((pair & (step < 0)).any()):
            return "block columns not strictly ascending within a block-row"
        return None
    ordered = torch.where(live, cols, cols.new_full((), -1)).sort(dim=1).values
    pair = ordered[:, 1:] >= 0
    if bool((pair & (ordered[:, 1:] == ordered[:, :-1])).any()):
        return "two tiles of one block-row share a block column"
    return None


def bcsr_to_dense(b: BcsrMatrix) -> torch.Tensor:
    m, n = b.shape
    bm, bn = b.block
    gm = b.blocks.shape[0]
    gn = (n + bn - 1) // bn
    out = torch.zeros((gm, gn, bm, bn), dtype=b.blocks.dtype,
                      device=b.blocks.device)
    rows = torch.arange(gm, device=b.blocks.device)[:, None].expand_as(b.blockcol)
    out.index_put_((rows, b.blockcol.long()), b.blocks, accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)[:m, :n]


# ---------------------------------------------------------------------------
# BCSR conv format (blocked filter banks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BcsrConv:
    """Block-sparse conv weights for an (M, C, R, S) filter bank, blocked over
    its flattened (M, C*R*S) matrix: column ``j`` of a tile at block-column
    ``bc`` is the weight ``(c, r, s)`` with ``bc*bn + j = c*R*S + r*S + s``;
    columns past C*R*S (right-padding) and rows past M carry zeros.

    blocks: (gbm, KB, bm, bn); blockcol: (gbm, KB) int32; nblocks: (gbm,)
    int32; scale: optional (gbm, bm) f32 per-output-channel scales of a
    quantised bank (``quantize_values``; tile row ``i`` of block-row ``g``
    is channel ``g*bm + i``, channel padding carries scale 1), whose tiles
    are then int8 or float8_e4m3fn.
    """

    blocks: torch.Tensor
    blockcol: torch.Tensor
    nblocks: torch.Tensor
    shape: Tuple[int, int, int, int]
    block: Tuple[int, int]
    scale: Optional[torch.Tensor] = None

    @property
    def kb(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def gbm(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def value_dtype(self) -> str:
        """Storage dtype name of the tiles."""
        return dtype_name(self.blocks.dtype)


def bcsr_conv_from_dense(w, block: Tuple[int, int] = (8, 128),
                         pad_to: int = 1, device="cuda") -> BcsrConv:
    """Convert a dense (M, C, R, S) filter bank to :class:`BcsrConv` with the
    :func:`bcsr_from_dense` tile rules on its (M, C*R*S) matrix."""
    w = np.asarray(w)
    if w.ndim != 4:
        raise ValueError(f"bcsr_conv_from_dense expects 4-D, got {w.shape}")
    m, c, r, s = w.shape
    flat = bcsr_from_dense(w.reshape(m, c * r * s), block, pad_to=pad_to,
                           device=device)
    return BcsrConv(blocks=flat.blocks, blockcol=flat.blockcol,
                    nblocks=flat.nblocks, shape=(m, c, r, s),
                    block=tuple(block))


def bcsr_conv_to_dense(b: BcsrConv) -> torch.Tensor:
    """Inverse of ``bcsr_conv_from_dense``; a quantised bank gives its
    dequantised f32 weights."""
    b = dequantize(b)
    m, c, r, s = b.shape
    flat = BcsrMatrix(blocks=b.blocks, blockcol=b.blockcol,
                      nblocks=b.nblocks, shape=(m, c * r * s), block=b.block)
    return bcsr_to_dense(flat).reshape(m, c, r, s)


# ---------------------------------------------------------------------------
# Quantised value streams (int8 / fp8 banks with per-channel f32 scales)
# ---------------------------------------------------------------------------

# Largest magnitude each narrow storage dtype carries: int8 the symmetric
# [-127, 127], fp8 e4m3fn its largest finite value, 448.
QUANT_DTYPES = {"int8": 127.0, "float8_e4m3fn": 448.0}
_STORAGE = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}


def _quant_scales(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-channel symmetric scale mapping |w| <= absmax onto [-qmax, qmax];
    an all-zero channel gets scale 1 (it quantises to exact zeros)."""
    absmax = absmax.float()
    return torch.where(absmax > 0, absmax / qmax,
                       torch.ones((), dtype=torch.float32,
                                  device=absmax.device))


def _quantize_array(w: torch.Tensor, scale: torch.Tensor,
                    value_dtype: str) -> torch.Tensor:
    """``w`` divided by its (broadcast) scale, rounded into storage: int8 to
    nearest, ties to even (``jnp.rint``), clipped to [-127, 127]; fp8 by the
    dtype cast (to nearest even)."""
    q = w.float() / scale
    if value_dtype == "int8":
        return torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    return q.to(_STORAGE[value_dtype])


def quantize_values(fmt, value_dtype: str = "int8"):
    """Quantise a conv bank's values to ``int8`` or ``float8_e4m3fn``.

    Per-output-channel symmetric quantisation, as the reference builds it:
    channel m's scale is ``absmax_m / 127`` (int8) or ``absmax_m / 448``
    (fp8), the values are stored narrow and the f32 scales ride in
    ``.scale``; the semantic weight is ``value * scale``.  Padding entries
    are zero and stay zero.  A bank already quantised raises.  Runs on the
    bank's device.
    """
    if value_dtype not in QUANT_DTYPES:
        raise ValueError(
            f"unsupported quantised value dtype {value_dtype!r}; "
            f"expected one of {sorted(QUANT_DTYPES)}")
    qmax = QUANT_DTYPES[value_dtype]
    if isinstance(fmt, EllConv):
        if fmt.scale is not None:
            raise ValueError("bank is already quantised")
        scale = _quant_scales(fmt.value.abs().amax(dim=1), qmax)
        value = _quantize_array(fmt.value, scale[:, None], value_dtype)
        return dataclasses.replace(fmt, value=value, scale=scale)
    if isinstance(fmt, BcsrConv):
        if fmt.scale is not None:
            raise ValueError("bank is already quantised")
        # (gbm, KB, bm, bn) -> per-(block-row, local-row) channel absmax
        scale = _quant_scales(fmt.blocks.abs().amax(dim=(1, 3)), qmax)
        blocks = _quantize_array(fmt.blocks, scale[:, None, :, None],
                                 value_dtype)
        return dataclasses.replace(fmt, blocks=blocks, scale=scale)
    raise TypeError(f"quantize_values expects EllConv or BcsrConv, "
                    f"got {type(fmt).__name__}")


def dequantize(fmt):
    """The f32 bank of a quantised one (``value.float() * scale``, one f32
    multiply, as the kernels dequantise in registers: the ELL kernel on a
    quantised bank is bit for bit the f32 kernel on this bank).  A bank
    that is not quantised passes through."""
    if isinstance(fmt, EllConv):
        if fmt.scale is None:
            return fmt
        value = fmt.value.float() * fmt.scale[:, None]
        return dataclasses.replace(fmt, value=value, scale=None)
    if isinstance(fmt, BcsrConv):
        if fmt.scale is None:
            return fmt
        blocks = fmt.blocks.float() * fmt.scale[:, None, :, None]
        return dataclasses.replace(fmt, blocks=blocks, scale=None)
    raise TypeError(f"dequantize expects EllConv or BcsrConv, "
                    f"got {type(fmt).__name__}")
