"""The work a layer needs and the least time the card could take for it.

Frozen here, apart from the program: the program's own pricing
(``repro_torch.tuning.measure``) prices what each kernel does, so a change
to a kernel would move its own bound.  These functions price the work the
layer needs, whatever implements it:

  FLOPs = 2 x nonzero weights x output pixels x batch
  bytes = input read once + output written once + nonzero values at 4 B
  bound = max(FLOPs / PEAK_FLOPS, bytes / HBM_BW)

The peak is the H100 SXM's TF32 tensor-core rate, the fastest at which the
card multiplies f32 operands, so no f32 kernel can read above 100 % of it.
Rates are NVIDIA's H100 SXM data sheet (dense, 700 W).
"""
from __future__ import annotations

from typing import Dict, Iterable

PEAK_FLOPS = 495e12   # TF32 tensor cores, FLOP/s
HBM_BW = 3.35e12      # HBM3, bytes/s
F32_BYTES = 4


def conv_flops(conv: Dict, nnz: int, batch: int) -> float:
    """Useful FLOPs of one conv: a multiply and an add a nonzero weight and
    output pixel."""
    return 2.0 * nnz * conv["e"] * conv["f"] * batch


def conv_bytes(conv: Dict, nnz: int, batch: int) -> float:
    """The input read once, the output written once, the nonzero values."""
    inp = batch * conv["c"] * conv["h"] * conv["w"]
    out = batch * conv["m"] * conv["e"] * conv["f"]
    return F32_BYTES * (inp + out + nnz)


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def conv_bound_s(conv: Dict, nnz: int, batch: int) -> float:
    return bound_s(conv_flops(conv, nnz, batch), conv_bytes(conv, nnz, batch))


def fc_flops(fc: Dict, batch: int) -> float:
    """An FC layer at its full fan-in: the port runs it dense."""
    return 2.0 * fc["in_f"] * fc["out_f"] * batch


def forward_flops(convs: Iterable[Dict], nnz: Dict[str, int],
                  fcs: Iterable[Dict], batch: int) -> float:
    """Useful FLOPs of one forward of ``batch`` images."""
    return (sum(conv_flops(c, nnz[c["name"]], batch) for c in convs)
            + sum(fc_flops(f, batch) for f in fcs))
