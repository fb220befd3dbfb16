"""Plain PyTorch forward of a CNN given by a configuration's layer table.

The table is the benchmark's own copy of the network (``configs/*.json``,
``"layers"``), in a small list language:

  ["conv", name, out_c, k, stride, pad, sparsity]
  ["relu"]
  ["pool", kind, k, stride, pad]          kind: max | avg | gap
  ["fc", name, out_f]                      no bias, run dense
  ["concat", [branch, ...]]                branches on channels
  ["residual", body, proj or null]         body(x) + (proj(x) or x)

Convolutions are ``F.conv2d`` with their bias, the FC layers ``x @ W``.
Everything is f32 with TF32 off (``tf32=True`` is the control: the same
forward with cuDNN's and cuBLAS's TF32 paths on; on the CPU, which has no
TF32, every operand of a conv or an FC is rounded to TF32's 10-bit
mantissa).  The FC weights are worked out here from the seed, with the
port's formula: ``numpy.random.default_rng(seed)`` draws each FC's
(in_f, out_f) normal matrix in table order, scaled by ``sqrt(1 / in_f)``.
Nothing here imports the program.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _out(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def walk_shapes(layers: Sequence[Any], in_shape: Tuple[int, int, int],
                ) -> Tuple[List[Dict], List[Dict]]:
    """The convs (in table order, a residual's body before its projection)
    and the FC layers, each with its input (c, h, w) and output (m, e, f)
    geometry."""
    convs: List[Dict] = []
    fcs: List[Dict] = []

    def conv(l, c, h, w):
        _, name, m, k, stride, pad, sparsity = l
        e, f = _out(h, k, stride, pad), _out(w, k, stride, pad)
        if e <= 0 or f <= 0:
            raise ValueError(f"conv {name}: {h}x{w} input is too small")
        convs.append(dict(name=name, c=c, h=h, w=w, m=m, k=k, stride=stride,
                          pad=pad, sparsity=float(sparsity), e=e, f=f))
        return m, e, f

    def seq(ls, c, h, w):
        for l in ls:
            kind = l[0]
            if kind == "conv":
                c, h, w = conv(l, c, h, w)
            elif kind == "pool":
                if l[1] == "gap":
                    h = w = 1
                else:
                    h, w = _out(h, l[2], l[3], l[4]), _out(w, l[2], l[3], l[4])
            elif kind == "concat":
                outs = [seq(br, c, h, w) for br in l[1]]
                c, h, w = sum(o[0] for o in outs), outs[0][1], outs[0][2]
            elif kind == "residual":
                bc, bh, bw = seq(l[1], c, h, w)
                if l[2] is not None:
                    conv(l[2], c, h, w)
                c, h, w = bc, bh, bw
            elif kind == "fc":
                fcs.append(dict(name=l[1], in_f=c * h * w, out_f=l[2]))
                c, h, w = l[2], 1, 1
            elif kind != "relu":
                raise ValueError(f"unknown layer {l!r}")
        return c, h, w

    seq(layers, *in_shape)
    return convs, fcs


def fc_weights(fcs: Sequence[Dict], seed: int, device) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(int(seed))
    return {f["name"]: torch.from_numpy(
        rng.standard_normal((f["in_f"], f["out_f"])).astype(np.float32)
        * (1.0 / f["in_f"]) ** 0.5).to(device) for f in fcs}


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _precision(tf32: bool):
    keep = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = keep


def forward(layers: Sequence[Any], convs: Dict[str, Tuple[torch.Tensor,
                                                           torch.Tensor]],
            fcs: Dict[str, torch.Tensor], x: torch.Tensor, *,
            tf32: bool = False) -> torch.Tensor:
    """Logits of ``x`` (N, C, H, W) through the table."""
    emulate = tf32 and x.device.type != "cuda"
    op = _round_tf32 if emulate else (lambda t: t)

    def conv(l, x):
        _, name, _, _, stride, pad, _ = l
        w, b = convs[name]
        return F.conv2d(op(x), op(w), b, stride=stride, padding=pad)

    def seq(ls, x):
        for l in ls:
            kind = l[0]
            if kind == "conv":
                x = conv(l, x)
            elif kind == "relu":
                x = torch.relu(x)
            elif kind == "pool":
                if l[1] == "gap":
                    x = x.mean(dim=(2, 3), keepdim=True)
                elif l[1] == "max":
                    x = F.max_pool2d(x, l[2], l[3], l[4])
                else:
                    x = F.avg_pool2d(x, l[2], l[3], l[4],
                                     count_include_pad=True)
            elif kind == "concat":
                x = torch.cat([seq(br, x) for br in l[1]], dim=1)
            elif kind == "residual":
                short = x if l[2] is None else conv(l[2], x)
                x = seq(l[1], x) + short
            elif kind == "fc":
                x = op(x.reshape(x.shape[0], -1)) @ op(fcs[l[1]])
        return x

    with torch.no_grad(), _precision(tf32):
        return seq(layers, x.float())
