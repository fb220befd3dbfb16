"""The single lowering pass: nested layer spec -> flat typed op program.

Port of ``repro/engine/lower.py`` (pure Python, copied; the ``conv_table``
order is kept, because parameter init draws its random numbers in it).

This replaces the four historical spec walkers (``init_cnn.walk``,
``cnn_forward.walk``, ``conv_layer_shapes.walk``, and the planner's network
walk): the spec is traversed exactly once here, with every geometry resolved
statically, and everything else — parameter init, execution, shape tables,
autotuning — consumes the resulting :class:`~repro_torch.engine.program.Program`.

Epilogue fusion happens at lowering time (the offline-compile step of
Yao et al., arXiv:1811.00206):

* ``Conv → ReLU``                  -> one ``ConvOp(fuse_relu=True)``
* bottleneck ``body[-1] is Conv``  -> the shortcut (projection conv or
  identity) is emitted first and the tail conv becomes
  ``ConvOp(res=<shortcut id>, fuse_relu=<trailing ReLU>)`` — the
  ``Conv → bias → +shortcut → ReLU`` chain the conv kernels execute as a
  single output write from the f32 accumulator (Park et al.,
  arXiv:1608.01409).

The ``conv_table`` keeps the historical spec-walk order (Residual: body
convs then projection) so parameter init draws RNG values in the exact
sequence the pre-engine ``init_cnn`` did.
"""
from __future__ import annotations

import itertools
from typing import Any, List, Sequence, Tuple

from repro_torch.core.direct_conv import out_spatial
from repro_torch.engine import spec
from repro_torch.engine.program import (ConcatOp, ConvOp, FCOp, PoolOp, Program,
                                  ReluOp, ResidualAddOp)


def lower(net: Sequence[Any], in_shape: Tuple[int, int, int]) -> Program:
    """Walk ``net`` once and emit a flat program.

    Args:
      net:      nested layer spec (``repro_torch.engine.spec`` dataclasses).
      in_shape: static input geometry ``(C, H, W)`` (batch stays dynamic).
    """
    c0, h0, w0 = (int(d) for d in in_shape)
    ops: List[Any] = []
    table: List[Tuple[spec.Conv, Tuple[int, int, int]]] = []
    ids = itertools.count(1)

    def emit_conv(l: spec.Conv, src: int, c: int, h: int, w: int, *,
                  res=None, fuse_relu: bool = False, defer_table: bool = False):
        e, f = out_spatial(h, w, l.k, l.k, l.stride, l.pad)
        if e <= 0 or f <= 0:
            raise ValueError(
                f"conv {l.name!r}: input {h}x{w} collapses to {e}x{f} "
                f"(k={l.k}, stride={l.stride}, pad={l.pad}) — image too small "
                "for this network")
        op = ConvOp(name=l.name, src=src, out=next(ids), c=c, h=h, w=w,
                    m=l.out_c, k=l.k, stride=l.stride, pad=l.pad,
                    sparsity=l.sparsity, e=e, f=f, fuse_relu=fuse_relu,
                    res=res)
        ops.append(op)
        entry = (l, (c, h, w))
        if not defer_table:
            table.append(entry)
        return op, entry

    def walk(layers, src: int, c: int, h: int, w: int):
        seq = list(layers)
        i = 0
        while i < len(seq):
            l = seq[i]
            nxt = seq[i + 1] if i + 1 < len(seq) else None
            if isinstance(l, spec.Conv):
                fuse = isinstance(nxt, spec.Relu)
                op, _ = emit_conv(l, src, c, h, w, fuse_relu=fuse)
                src, c, h, w = op.out, op.m, op.e, op.f
                if fuse:
                    i += 1
            elif isinstance(l, spec.Relu):
                op = ReluOp(src=src, out=next(ids))
                ops.append(op)
                src = op.out
            elif isinstance(l, spec.Pool):
                if l.kind == "gap":
                    e = f = 1
                else:
                    e, f = out_spatial(h, w, l.k, l.k, l.stride, l.pad)
                    if e <= 0 or f <= 0:
                        raise ValueError(
                            f"pool({l.kind}): input {h}x{w} collapses to "
                            f"{e}x{f} — image too small for this network")
                op = PoolOp(kind=l.kind, k=l.k, stride=l.stride, pad=l.pad,
                            src=src, out=next(ids), e=e, f=f)
                ops.append(op)
                src, h, w = op.out, e, f
            elif isinstance(l, spec.Concat):
                outs, c_sum = [], 0
                bh, bw = h, w
                for br in l.branches:
                    s2, c2, bh, bw = walk(br, src, c, h, w)
                    outs.append(s2)
                    c_sum += c2
                op = ConcatOp(srcs=tuple(outs), out=next(ids))
                ops.append(op)
                src, c, h, w = op.out, c_sum, bh, bw
            elif isinstance(l, spec.Residual):
                fuse = isinstance(nxt, spec.Relu)
                body = list(l.body)
                if body and isinstance(body[-1], spec.Conv):
                    # Fusable tail: shortcut first, then the tail conv with
                    # the whole +shortcut→ReLU epilogue attached.
                    bsrc, bc, bh, bw = walk(body[:-1], src, c, h, w)
                    pentry = None
                    if l.proj is not None:
                        pop, pentry = emit_conv(l.proj, src, c, h, w,
                                                defer_table=True)
                        sc = pop.out
                    else:
                        sc = src
                    lop, _ = emit_conv(body[-1], bsrc, bc, bh, bw, res=sc,
                                       fuse_relu=fuse)
                    if pentry is not None:
                        table.append(pentry)  # spec order: body, then proj
                    src, c, h, w = lop.out, lop.m, lop.e, lop.f
                else:
                    bsrc, bc, bh, bw = walk(body, src, c, h, w)
                    if l.proj is not None:
                        pop, _ = emit_conv(l.proj, src, c, h, w)
                        sc = pop.out
                    else:
                        sc = src
                    op = ResidualAddOp(a=bsrc, b=sc, out=next(ids),
                                       fuse_relu=fuse)
                    ops.append(op)
                    src, c, h, w = op.out, bc, bh, bw
                if fuse:
                    i += 1
            elif isinstance(l, spec.FC):
                op = FCOp(name=l.name, src=src, out=next(ids),
                          in_f=c * h * w, out_f=l.out_f)
                ops.append(op)
                src, c, h, w = op.out, l.out_f, 1, 1
            else:
                raise TypeError(f"unknown layer spec {l!r}")
            i += 1
        return src, c, h, w

    out, _, _, _ = walk(net, 0, c0, h0, w0)
    return Program(ops=tuple(ops), out=out, in_shape=(c0, h0, w0),
                   conv_table=tuple(table))
