"""Plain PyTorch version of the BCSR conv kernel.

``bsr_conv_plain`` takes the kernel's operands (a quantised bank's int8 or e4m3
tiles with their (gbm, bm) scales too) and returns what the kernel returns: for
every block-row and every kept tile ``kb < nblocks``, the (bn, E, F) im2col
patch of flat columns ``blockcol*bn + jl`` (channel clamped to C-1 for the
format's right-padding columns) is gathered from the padded input and
contracted in f32 against the (bm, bn) tile; then bias, residual and ReLU, and
the result rounded once to the input's dtype (bf16 inputs, residuals and tiles
widened exactly to f32: a product of two bf16 values is exact in f32, as on the
kernel's bf16 tensor cores).  It is vectorised over block-rows and loops only
over the KB axis.  The contraction's summation order is the library's, not the
kernel's, so the two agree to f32 rounding, not bit for bit.

``bsr_conv_split_plain`` mirrors the kernel's split arithmetic (TF32 hi and
lo halves of both operands, three products); with ``lo=False`` it is the
one-product control the precision checks must reject.
``bsr_conv_bf16_plain`` mirrors the kernel's walk on bf16 activations: a
group of ``n_tile`` output channels visits the block columns any of its
rows keeps, in ascending order, and each 16-deep step adds its exact
products into one f32 sum a channel (no partials).

``bsr_conv_blocked_ref`` is the port of the reference's
``bsr_conv_blocked_ref`` (``repro/kernels/bsr_conv/ref.py:54``): the same
math from an unpadded input and a ``BcsrConv``, in natural channel order.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.direct_conv import (gather_windows, out_spatial,
                                          pad_in, pixel_offsets,
                                          stretched_offsets)
from repro_torch.core.sparse_format import BcsrConv


def _blocked(xpad, blocks, blockcol, nblocks, bias, residual, *, rs, s, e,
             f, stride, fuse_relu, contract, scale=None) -> torch.Tensor:
    """For every kept tile, the (bn, E*F) im2col patch of its columns and
    ``contract(tile, patch)``, summed tile by tile; a quantised bank's sums
    times their channel's scale (once, as the kernel's epilogue does);
    then the epilogue."""
    n, c, hp, wp = xpad.shape
    gbm, _, bm, bn = blocks.shape
    dtype = xpad.dtype
    xpad = xpad.float()
    pix = pixel_offsets(wp, e, f, stride, xpad.device)
    jl = torch.arange(bn, device=xpad.device)
    acc = torch.zeros((n, gbm, bm, e * f), dtype=torch.float32,
                      device=xpad.device)
    kb_n = int(nblocks.max()) if gbm else 0
    for kb in range(kb_n):
        j = blockcol[:, kb].long()[:, None] * bn + jl        # (gbm, bn)
        cj = j // rs
        rr = (j - cj * rs) // s
        ss = j - cj * rs - rr * s
        off = stretched_offsets(cj.clamp(max=c - 1), rr, ss, hp, wp)
        patch = gather_windows(xpad, off, pix)                # (N, gbm, bn, EF)
        live = (nblocks > kb).view(gbm, 1, 1)
        tile = torch.where(live, blocks[:, kb].float(), 0.0)  # (gbm, bm, bn)
        acc += contract(tile, patch)
    if scale is not None:
        acc = acc * scale.float().view(1, gbm, bm, 1)
    out = acc.reshape(n, gbm * bm, e, f) + bias.float().view(1, -1, 1, 1)
    if residual is not None:
        out = out + residual.float()
    if fuse_relu:
        out = torch.relu(out)
    return out.to(dtype)


def _product(tile: torch.Tensor, patch: torch.Tensor) -> torch.Tensor:
    return torch.einsum("gmb,ngbp->ngmp", tile, patch)


def bsr_conv_plain(xpad: torch.Tensor, blocks: torch.Tensor,
                   blockcol: torch.Tensor, nblocks: torch.Tensor,
                   bias: torch.Tensor,
                   residual: Optional[torch.Tensor] = None, *, rs: int,
                   s: int, e: int, f: int, stride: int = 1,
                   fuse_relu: bool = False,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C, Hp, Wp) padded input (f32 or bf16), (gbm, KB, bm, bn) tiles
    -> (N, gbm*bm, E, F) in the input's dtype with the fused epilogue;
    ``bias`` is (gbm*bm,), ``residual``
    (N, gbm*bm, E, F); ``scale`` (gbm, bm) f32 goes with int8 or e4m3
    tiles (a quantised bank)."""
    return _blocked(xpad, blocks, blockcol, nblocks, bias, residual, rs=rs,
                    s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu,
                    contract=_product, scale=scale)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from zero,
    as the kernel's cvt.rna.tf32.f32), kept as f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """f32 ``x`` -> (hi, lo) as f32 values: hi = tf32(x), lo = tf32(x - hi),
    so hi + lo keeps about 21 bits of x's mantissa."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def bsr_conv_split_plain(xpad: torch.Tensor, blocks: torch.Tensor,
                         blockcol: torch.Tensor, nblocks: torch.Tensor,
                         bias: torch.Tensor,
                         residual: Optional[torch.Tensor] = None, *,
                         rs: int, s: int, e: int, f: int, stride: int = 1,
                         fuse_relu: bool = False, lo: bool = True,
                         scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The CUDA kernel's arithmetic on the CPU: each tile and patch split
    into TF32 halves, and three products x_hi w_hi + x_hi w_lo + x_lo w_hi
    (each exact in f32: a product of two TF32 values fits its mantissa),
    summed in f32.  A quantised bank's tiles are exact in TF32 (w_lo is 0,
    the kernel's two products), and its sums are scaled as in
    ``bsr_conv_plain``.  ``lo=False`` is the control a check must reject:
    one product of the operands rounded once to TF32."""
    def contract(tile, patch):
        w_hi, w_lo = split_tf32(tile)
        x_hi, x_lo = split_tf32(patch)
        out = _product(w_hi, x_hi)
        if lo:
            out = out + _product(w_lo, x_hi) + _product(w_hi, x_lo)
        return out

    return _blocked(xpad, blocks, blockcol, nblocks, bias, residual, rs=rs,
                    s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu,
                    contract=contract, scale=scale)


def bsr_conv_bf16_plain(xpad: torch.Tensor, blocks: torch.Tensor,
                        blockcol: torch.Tensor, nblocks: torch.Tensor,
                        bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, *, rs: int,
                        s: int, e: int, f: int, stride: int = 1,
                        fuse_relu: bool = False, n_tile: int = 128,
                        scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The kernel's walk on bf16 activations, for the tests: the block-rows
    in groups of ``n_tile // bm``; each group's live block columns (kept by
    any of its rows) in ascending order, a row keeping no tile there
    contributing zeros; each column's 128 flat columns in 16-deep steps,
    each step's products (exact: bf16 x bf16) summed exactly and added
    into one f32 sum a channel, rounded once a step (a model of the tensor
    cores' accumulation, which rounds by truncation: the card's results
    are held to one bf16 ulp, not to these bits); then a quantised bank's
    scales and the epilogue, rounded once to xpad's dtype."""
    n, c, hp, wp = xpad.shape
    gbm, kb_n, bm, bn = blocks.shape
    nb = n_tile // bm
    ncols = -(-c * rs // bn)
    x = xpad.double()
    pix = pixel_offsets(wp, e, f, stride, xpad.device)
    jl = torch.arange(bn, device=xpad.device)
    dense = torch.zeros((gbm, ncols, bm, bn), dtype=torch.float64)
    for i in range(gbm):
        for kb in range(int(nblocks[i])):
            dense[i, int(blockcol[i, kb])] = blocks[i, kb].double()
    acc = torch.zeros((n, gbm * bm, e * f), dtype=torch.float32)
    for g0 in range(0, gbm, nb):
        rows = slice(g0, min(g0 + nb, gbm))
        keeps = torch.zeros(ncols, dtype=torch.bool)
        for i in range(rows.start, rows.stop):
            keeps[blockcol[i, :int(nblocks[i])].long()] = True
        part = acc[:, rows.start * bm:rows.stop * bm]
        for j in keeps.nonzero().flatten().tolist():
            col = j * bn + jl
            cj = col // rs
            rr = (col - cj * rs) // s
            ss = col - cj * rs - rr * s
            off = stretched_offsets(cj.clamp(max=c - 1), rr, ss, hp, wp)
            patch = gather_windows(x, off[None, :], pix)[:, 0]  # (N, bn, EF)
            w = dense[rows, j].reshape(-1, bn)                   # (rows, bn)
            for k0 in range(0, bn, 16):
                step = torch.einsum("mk,nkp->nmp", w[:, k0:k0 + 16],
                                    patch[:, k0:k0 + 16])
                part = (part.double() + step).float()
        acc[:, rows.start * bm:rows.stop * bm] = part
    acc = acc.view(n, gbm, bm, e * f)
    if scale is not None:
        acc = acc * scale.float().view(1, gbm, bm, 1)
    out = acc.reshape(n, gbm * bm, e, f) + bias.float().view(1, -1, 1, 1)
    if residual is not None:
        out = out + residual.float()
    if fuse_relu:
        out = torch.relu(out)
    return out.to(xpad.dtype)


def bsr_conv_blocked_ref(x: torch.Tensor, bc: BcsrConv, *, stride: int = 1,
                         padding: int = 0,
                         bias: Optional[torch.Tensor] = None,
                         fuse_relu: bool = False,
                         residual: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """The blocked contraction from an (N, C, H, W) input; (N, M, E, F) in
    the input's dtype."""
    m, _, r, s = bc.shape
    gbm, _, bm, _ = bc.blocks.shape
    mpad = gbm * bm
    e, f = out_spatial(x.shape[2], x.shape[3], r, s, stride, padding)
    b = torch.zeros((mpad,), dtype=torch.float32, device=x.device)
    if bias is not None:
        b[:m] = bias.float()
    res = residual
    if res is not None and mpad != m:
        res = torch.nn.functional.pad(res, (0, 0, 0, 0, 0, mpad - m))
    out = bsr_conv_plain(pad_in(x, padding), bc.blocks, bc.blockcol,
                         bc.nblocks, b, res, rs=r * s, s=s, e=e, f=f,
                         stride=stride, fuse_relu=fuse_relu, scale=bc.scale)
    return out[:, :m]
