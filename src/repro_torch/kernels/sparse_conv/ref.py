"""Plain PyTorch version of the ELL direct sparse conv kernel.

Same operands and the same result as ``csrc/sparse_conv.cu``: every row's sum
is formed nonzero by nonzero in f32 (``acc + value * window``, the multiply and
the add rounded separately), then bias, residual and ReLU are applied in the
kernel's order, and the result is rounded once to the input's dtype.  bf16
inputs, residuals and banks are widened exactly to f32 (every bf16 value is an
f32 value), so the sums are the ones the f32 version forms on the widened
operands.  It is vectorised over rows and pixels and loops only over the K
axis, up to the longest row; a row's entries past its ``nnz`` are padding with
value 0, so adding them leaves its sum unchanged.

The CPU tests run the port through it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.

``stretch_bank`` stretches a bank for the CUDA kernel (slab offsets and the
runs of each channel chunk; its launcher calls it once per bank and
schedule): (offset, f32 value) pairs, a quantised bank's words, or a bf16
bank's words (offset << 16 | bf16 bits, for bf16 activations), the offsets
in the slab's elements or, for a paired slab, in its plane words.
``sparse_conv_walk_plain`` mirrors the kernel's traversal (pixel tiles,
staged input slabs and their planes, channel chunks, one pointer a row),
for the tests, never on the main path: it forms every sum in the same
order, so it equals ``sparse_conv_plain`` bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.direct_conv import (gather_windows, pixel_offsets,
                                          stretched_offsets)


def dequantized(value: torch.Tensor,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 values the kernel multiplies: a quantised bank's int8 or
    e4m3 values times their row's scale, one f32 multiply each (what
    ``core.sparse_format.dequantize`` computes); an f32 bank's as they
    are."""
    if scale is None:
        return value.float()
    return value.float() * scale.float()[:, None]


def sparse_conv_plain(xpad: torch.Tensor, value: torch.Tensor,
                      packed_idx: torch.Tensor, nnz: torch.Tensor,
                      bias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None, *, rs: int,
                      s: int, e: int, f: int, stride: int = 1,
                      fuse_relu: bool = False,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C, Hp, Wp) padded input (f32 or bf16), (M, K) values and packed
    indices -> (N, M, E, F) in the input's dtype with the fused epilogue.
    ``scale`` (M,) f32 goes with a quantised bank's int8 or e4m3 values."""
    n, _, hp, wp = xpad.shape
    m = value.shape[0]
    dtype = xpad.dtype
    value = dequantized(value, scale)
    xpad = xpad.float()
    packed = packed_idx.long()
    cidx = packed // rs
    ridx = (packed - cidx * rs) // s
    sidx = packed - cidx * rs - ridx * s
    off = stretched_offsets(cidx, ridx, sidx, hp, wp)
    pix = pixel_offsets(wp, e, f, stride, xpad.device)
    acc = torch.zeros((n, m, e * f), dtype=torch.float32, device=xpad.device)
    kmax = int(nnz.max()) if m else 0
    for k in range(kmax):
        acc += value[:, k].view(1, m, 1) * gather_windows(xpad, off[:, k], pix)
    acc = acc.view(n, m, e, f)
    acc += bias.float().view(1, m, 1, 1)
    if residual is not None:
        acc += residual.float()
    if fuse_relu:
        acc = torch.relu(acc)
    return acc.to(dtype)


def slab_width(wp: int, itemsize: int) -> int:
    """The padded input's width the staged kernel takes: a bf16 slab is
    copied two elements (4 bytes, one ``cp.async``) at a time, so a bf16
    input's rows have an even width (``ops`` pads one more zero column
    where the padded width is odd; the column feeds only dropped
    pixels)."""
    return wp + wp % 2 if itemsize == 2 else wp


def slab_geometry(hp: int, wp: int, r: int, s: int, e: int, f: int,
                  stride: int) -> Tuple[int, int, int]:
    """(hs, ws, st): an image's rows and columns in the slab's coordinates
    and the stride there.  A strided 1x1 conv stages only the pixels it
    reads, as a stride-1 conv on an (e, f) image; any other conv stages
    whole padded rows."""
    if r == s == 1 and stride > 1:
        return e, f, 1
    return hp, wp, stride


def plane_words(elems: int) -> int:
    """Words of one plane of a paired slab whose elements (the copied ones
    and the slack) number ``elems``: plane 1's word k is built from plane
    0's words k and k + 1; a multiple of 4, so that plane 1 starts that
    many words after plane 0 (the source's ``plane_words``)."""
    return -(-((elems + 1) // 2 + 2) // 4) * 4


def paired_slab_elems(cc: int, rows: int, ws: int, s: int) -> int:
    """Elements a paired slab's planes cover: the copied ones and a slack
    of ``s`` + 1 (a dropped pixel pair's second read)."""
    return cc * rows * ws + s + 1


def pixel_row(ws: int, f: int, st: int) -> int:
    """The kernel's pixels an output row: at stride 1 the slab's whole width
    ``ws`` (the last ``ws - f`` computed and dropped, so that a warp's lanes
    read neighbouring slab words), else ``f``."""
    return ws if st == 1 else f


# a quantised bank's word: the slab offset in words above the value byte
WORD_OFFSET_LIMIT = 1 << 23
# a bf16 bank's word: the slab offset above the value's 16 bits
BF16_OFFSET_LIMIT = 1 << 16


def bf16_offsets(cc: int, rows: int, ws: int, s: int, *, rs: int,
                 paired: bool = False) -> int:
    """How many values a bf16 word's offset field takes for this slab (the
    largest plus one, at most): its elements (a staged conv), its two
    planes' words (paired), or the channels (a 1x1 conv, whose words hold
    the channel)."""
    if rs == 1:
        return cc
    if paired:
        return 2 * plane_words(paired_slab_elems(cc, rows, ws, s))
    return cc * rows * ws


def entry_format(value_dtype: torch.dtype, itemsize: int, rs: int, s: int,
                 ws: int, schedule) -> Tuple[bool, bool]:
    """(words, paired): whether the launcher streams a bank as bf16 words
    (a bf16 bank on bf16 activations whose slab offsets fit the word's 16
    bits; else (offset, f32 value) pairs, the same sums), and whether the
    kernel reads the schedule's paired slab (which only bf16 words
    address; any other bank runs the unpaired kernel on the schedule's
    chunks, whose stages fit all the more)."""
    if value_dtype != torch.bfloat16 or itemsize != 2:
        return False, False
    paired = bool(schedule.paired)
    fits = bf16_offsets(schedule.cc, schedule.rows, ws, s, rs=rs,
                        paired=paired) <= BF16_OFFSET_LIMIT
    return fits, fits and paired


def stretch_bank(value: torch.Tensor, packed_idx: torch.Tensor,
                 nnz: torch.Tensor, *, rs: int, s: int, ws: int, rows: int,
                 cc: int, c: int, itemsize: int = 4, words: bool = False,
                 paired: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's weight stretching for the CUDA kernel's slabs, on the
    bank's device: ``pairs`` (M, K, 2) int32, each nonzero's byte offset in a
    slab of ``cc`` channels x ``rows`` x ``ws`` elements of ``itemsize`` bytes
    (the activation's: 4 for f32, 2 for bf16), itemsize*((c % cc)*rows*ws +
    r*ws + s), beside its f32 value's bits (a bf16 bank's values widened to
    f32, exactly); and ``rowptr`` (M, C/cc + 1) int32, row m's entries of
    channel chunk k being rowptr[m, k] .. rowptr[m, k + 1].  A quantised bank
    (int8 or float8_e4m3fn ``value``) gets (M, K) int32 words instead,
    (offset in elements) << 8 | the value's byte: its narrow values stream
    at 4 bytes a nonzero, not 8.  ``words``: a bf16 bank's (M, K) words for
    bf16 activations, offset << 16 | the value's bf16 bits, the offset the
    element's, or where ``paired`` the plane word's of the paired slab
    (element o of the slab: word o // 2 of plane o % 2, planes of
    ``plane_words`` words each), or for a 1x1 conv (``rs`` 1) the channel.
    Raises unless every row's packed indices ascend up to its nnz (the
    (c, r, s) order ``ell_from_dense_conv`` builds), which the chunk runs
    rely on, and, for words, unless every offset is below
    ``WORD_OFFSET_LIMIT`` (quantised) or ``BF16_OFFSET_LIMIT`` (bf16)."""
    m, k = packed_idx.shape
    nchunks = -(-c // cc)
    packed = packed_idx.long()
    live = torch.arange(k, device=packed.device)[None, :] < nnz.long()[:, None]
    if bool((live[:, 1:] & (packed[:, 1:] <= packed[:, :-1])).any()):
        raise ValueError("sparse_conv: a row's nonzeros are not in ascending "
                         "(c, r, s) order")
    quant = value.dtype not in (torch.float32, torch.bfloat16)
    if words and (value.dtype != torch.bfloat16 or itemsize != 2):
        raise ValueError("sparse_conv: one-word entries hold a bf16 bank's "
                         "values for bf16 activations")
    if paired and (not words or rs == 1):
        raise ValueError("sparse_conv: a paired slab is read by a bf16 "
                         "bank's words, in a staged conv")
    cidx = packed // rs
    r = (packed - cidx * rs) // s
    elems = (cidx % cc) * rows * ws + r * ws + (packed - cidx * rs - r * s)
    if words:
        if rs == 1:
            off = cidx
        elif paired:
            pw = plane_words(paired_slab_elems(cc, rows, ws, s))
            off = (elems & 1) * pw + (elems >> 1)
        else:
            off = elems
        if bool((live & (off >= BF16_OFFSET_LIMIT)).any()):
            raise ValueError("sparse_conv: a bf16 bank's one-word slab "
                             f"offsets reach {BF16_OFFSET_LIMIT}")
        bits = value.contiguous().view(torch.int16).long() & 0xFFFF
        pairs = ((torch.where(live, off, 0) << 16) | bits)
        pairs = torch.where(pairs >= 2**31, pairs - 2**32, pairs)
        pairs = pairs.to(torch.int32)
    elif not quant:
        pairs = torch.stack([(itemsize * elems).to(torch.int32),
                             value.float().contiguous().view(torch.int32)],
                            -1)
    else:
        if bool((live & (elems >= WORD_OFFSET_LIMIT)).any()):
            raise ValueError("sparse_conv: a quantised bank's slab offsets "
                             f"reach {WORD_OFFSET_LIMIT} words")
        byte = value.contiguous().view(torch.uint8).long()
        pairs = ((torch.where(live, elems, 0) << 8) | byte).to(torch.int32)
    chunk = torch.where(live, cidx // cc, torch.full_like(cidx, nchunks))
    counts = torch.zeros((m, nchunks + 1), dtype=torch.long,
                         device=packed.device)
    counts.scatter_add_(1, chunk, torch.ones_like(chunk))
    rowptr = torch.zeros((m, nchunks + 1), dtype=torch.long,
                         device=packed.device)
    rowptr[:, 1:] = torch.cumsum(counts[:, :nchunks], dim=1)
    return pairs.contiguous(), rowptr.to(torch.int32)


def e4m3_to_f32(byte: torch.Tensor) -> torch.Tensor:
    """e4m3 (fn) bytes -> f32 by their bit fields, as the kernel decodes
    them: exponent 0 subnormal (mantissa x 2^-9), else (1 + m/8) x
    2^(e - 7)."""
    b = byte.long()
    e, m = (b >> 3) & 0xF, b & 7
    normal = ((e + 120) << 23 | (m << 20)).to(torch.int32).view(torch.float32)
    mag = torch.where(e > 0, normal, m.float() * 2.0 ** -9)
    return torch.where((b & 0x80) > 0, -mag, mag)


def unstretch(pairs: torch.Tensor, value_dtype: torch.dtype,
              scale: Optional[torch.Tensor], itemsize: int = 4, *,
              words: bool = False):
    """(offsets, f32 values) of a stretched bank, decoded as the kernel
    decodes them: an f32 or bf16 bank's pairs (element offsets from byte
    offsets at the activation's ``itemsize``), a quantised bank's words
    (the byte an int8 or an e4m3 value, times its row's scale, rounded
    once), or a bf16 bank's ``words`` (the offset field as stored: an
    element, a plane word or a channel; the value widened exactly)."""
    if words:
        w = pairs.long() & 0xFFFFFFFF
        bits = (w & 0xFFFF) << 16
        bits = torch.where(bits >= 2**31, bits - 2**32, bits)
        return w >> 16, bits.to(torch.int32).view(torch.float32)
    if value_dtype in (torch.float32, torch.bfloat16):
        return (pairs[..., 0].long() // itemsize,
                pairs[..., 1].contiguous().view(torch.float32))
    w = pairs.long() & 0xFFFFFFFF
    byte = (w & 0xFF).to(torch.uint8)
    q = (byte.view(torch.int8).float() if value_dtype == torch.int8
         else e4m3_to_f32(byte))
    return w >> 8, q * scale.float()[:, None]


def _epilogue(acc, bias, residual, fuse_relu, dtype):
    out = acc.permute(1, 0, 2, 3)
    out = out + bias.float().view(1, -1, 1, 1)
    if residual is not None:
        out = out + residual.float()
    if fuse_relu:
        out = torch.relu(out)
    return out.to(dtype).contiguous()


def _walk_direct(xpad, value, packed_idx, nnz, bias, residual, *, e, f,
                 stride, fuse_relu, schedule, scale):
    """The 1x1 kernel's walk: pixel tiles of ``schedule.tp``, each row's
    whole run at offsets c*Hp*Wp from each pixel's input in xpad (a bf16
    word's channel times Hp*Wp; a paired schedule's pixel pairs read as
    one word of two neighbouring inputs)."""
    n, c, hp, wp = xpad.shape
    m = value.shape[0]
    size = xpad.element_size()
    words, paired = entry_format(value.dtype, size, 1, 1, wp, schedule)
    pairs, rowptr = stretch_bank(value, packed_idx, nnz, rs=1, s=1, ws=wp,
                                 rows=hp, cc=c, c=c, itemsize=size,
                                 words=words)
    off, val = unstretch(pairs, value.dtype, scale, size, words=words)
    if words:
        off = off * (hp * wp)
    flat = xpad.float().reshape(-1)
    ef = e * f
    q = torch.arange(n * ef)
    if paired:   # each pixel read from its pair's word, (first, second)
        q, half = q - q % 2, q % 2
        flat = flat.view(-1, 2)
    pn, pe, pf = q // ef, (q % ef) // f, q % f
    base = (pn * c * hp + pe * stride) * wp + pf * stride
    acc = torch.zeros((m, n * ef), dtype=torch.float32)
    start, end = rowptr[:, 0].long(), rowptr[:, 1].long()
    for q0 in range(0, n * ef, schedule.tp):
        tile = base[q0:q0 + schedule.tp]
        for i in range(int((end - start).max()) if m else 0):
            live = (start + i < end).nonzero().flatten()
            kk = start[live] + i
            at = off[live, kk][:, None] + tile[None, :]
            x = (flat[at // 2, half[q0:q0 + schedule.tp][None, :]] if paired
                 else flat[at])
            acc[live, q0:q0 + schedule.tp] += val[live, kk][:, None] * x
    return _epilogue(acc.view(m, n, e, f), bias, residual, fuse_relu,
                     xpad.dtype)


def sparse_conv_walk_plain(xpad: torch.Tensor, value: torch.Tensor,
                           packed_idx: torch.Tensor, nnz: torch.Tensor,
                           bias: torch.Tensor,
                           residual: Optional[torch.Tensor] = None, *,
                           rs: int, s: int, e: int, f: int, stride: int = 1,
                           fuse_relu: bool = False, schedule,
                           scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The CUDA kernel's walk on its operands, for the tests: the bank
    stretched as the launcher stretches it (``entry_format``,
    ``stretch_bank``); for each tile of ``schedule.tp`` output pixels (flat
    over (n, e, f)), the input slab its windows read (whole padded rows,
    across images, each channel ``schedule.rows`` rows apart), channel
    chunk by channel chunk of ``schedule.cc``; each row's run of the chunk
    added nonzero by nonzero at its stretched offset.  A paired schedule's
    slab is read as the kernel reads it: its two planes (plane 0 the slab's
    element pairs, plane 1 the pairs shifted by one), each pixel pair from
    the word at its pair's origin plus the entry's plane-word offset.  A
    1x1 conv walks as its unstaged kernel does, straight from xpad.  Raises
    if a tile's slab is taller than ``schedule.rows``.  Same operands and,
    bit for bit, the same result as ``sparse_conv_plain``; a quantised
    bank (with ``scale``) walks the words the kernel decodes, a bf16 input
    its bf16 slabs (offsets in 2-byte elements), widened exactly at each
    product."""
    if rs == 1:   # a 1x1 conv reads xpad directly, one run a row
        return _walk_direct(xpad, value, packed_idx, nnz, bias, residual,
                            e=e, f=f, stride=stride, fuse_relu=fuse_relu,
                            schedule=schedule, scale=scale)
    n, c, hp, wp = xpad.shape
    m = value.shape[0]
    dtype, size = xpad.dtype, xpad.element_size()
    src = xpad.float()
    cc, tp, rows = schedule.cc, schedule.tp, schedule.rows
    hs, ws, st = slab_geometry(hp, wp, rs // s, s, e, f, stride)
    words, paired = entry_format(value.dtype, size, rs, s, ws, schedule)
    pairs, rowptr = stretch_bank(value, packed_idx, nnz, rs=rs, s=s, ws=ws,
                                 rows=rows, cc=cc, c=c, itemsize=size,
                                 words=words, paired=paired)
    off, val = unstretch(pairs, value.dtype, scale, size, words=words)
    pw = plane_words(paired_slab_elems(cc, rows, ws, s))
    rowptr = rowptr.long()
    rt = rs // s
    wq = pixel_row(ws, f, st)
    eq = e * wq
    q_all = torch.arange(n * eq)
    acc = torch.zeros((m, n * eq), dtype=torch.float32)
    for q0 in range(0, n * eq, tp):
        q = q_all[q0:q0 + tp]
        q1 = int(q[-1])
        ga = (q0 // eq) * hs + (q0 % eq) // wq * st
        rb = (q1 // eq) * hs + (q1 % eq) // wq * st + rt - 1 - ga + 1
        if rb > rows:
            raise ValueError(f"tile at pixel {q0} reads {rb} slab rows, "
                             f"more than the schedule's {rows}")
        g = torch.arange(ga, ga + rb)
        # (C, rows, ws): the padded rows ga .. of every channel, zero below,
        # and the kernel's slack past the last
        slab = torch.zeros((c, rows, ws))
        slab[:, :rb] = src[g // hs, :, g % hs, :].permute(1, 0, 2)
        if paired:   # a pixel pair's origin, even, and the pixel's half
            first, half = q - (q - q0) % 2, (q - q0) % 2
        else:
            first = q
        pn, pq = first // eq, first % eq
        pix = (pn * hs + pq // wq * st - ga) * ws + (pq % wq) * st
        for k0 in range(0, rowptr.shape[1] - 1):
            chunk = slab[k0 * cc:(k0 + 1) * cc].reshape(-1)
            if paired:
                flat = torch.cat([chunk, torch.zeros(2 * pw - len(chunk))])
                planes = torch.cat([flat.view(pw, 2),
                                    torch.stack([flat[1:-1:2], flat[2::2]],
                                                -1),
                                    torch.zeros(1, 2)])
            else:
                flat = torch.cat([chunk, torch.zeros(s)])
            start, end = rowptr[:, k0], rowptr[:, k0 + 1]
            for i in range(int((end - start).max()) if m else 0):
                live = (start + i < end).nonzero().flatten()
                kk = start[live] + i
                if paired:
                    word = off[live, kk][:, None] + (pix // 2)[None, :]
                    x = planes[word, half[None, :]]
                else:
                    x = flat[off[live, kk][:, None] + pix[None, :]]
                acc[live, q0:q0 + tp] += val[live, kk][:, None] * x
    # drop the pixels past each row's f
    return _epilogue(acc.view(m, n, e, wq)[..., :f], bias, residual,
                     fuse_relu, dtype)
