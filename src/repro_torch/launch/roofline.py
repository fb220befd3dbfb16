"""Roofline constants of one H100 SXM, the card the port runs on.

Port of the constant half of ``repro/launch/roofline.py``, re-derived from
NVIDIA's H100 SXM data sheet (dense rates, 700 W); the HLO and collective
half waits for the dry run (ROADMAP Queue 1 item 9).  The autotuner (``tuning/measure.py``)
prices each conv method at the unit its kernel issues on:

  dense       cuDNN with TF32 off: the f32 FMA units, ``F32_FLOPS``
  pallas      the ELL kernel (``kernels/sparse_conv/csrc``): a multiply and
              an add rounded apart, two instructions a nonzero and pixel,
              so half the f32 FMA rate; and one 4-byte shared-memory read
              a multiply-add (32 a clock an SM), which caps it below that:
              ``ELL_FLOPS``
  bsr         the BCSR kernel (``kernels/bsr_conv/csrc``) on the tensor
              cores in TF32: three products of split halves, two for a
              quantised bank (int8 and e4m3 values are exact in TF32),
              at ``TF32_FLOPS``

Bytes move at ``HBM_BW``.  Units: bytes per second, FLOP/s.
"""
from __future__ import annotations

from repro_torch.kernels.budget import (VALUE_ITEMSIZES,  # noqa: F401
                                        value_itemsize)

HBM_BW = 3.35e12            # HBM3
F32_FLOPS = 67e12           # f32 on the FMA units
TF32_FLOPS = 495e12         # TF32 tensor cores
BF16_FLOPS = 989e12         # bf16 tensor cores
INT8_FLOPS = 1979e12        # int8 tensor cores (TOP/s)
FP8_FLOPS = 1979e12         # e4m3 tensor cores
SMS = 132
BOOST_HZ = 1.98e9           # the SM clock at which the peaks above hold
# 4-byte shared-memory reads a second: 32 banks a clock an SM
SMEM_READS = 32 * SMS * BOOST_HZ
# The ELL kernel: min(two FP instructions a multiply-add, one shared-memory
# read a multiply-add), in FLOP/s (2 a multiply-add)
ELL_FLOPS = min(F32_FLOPS / 2, 2 * SMEM_READS)
