"""Roofline constants of one H100 SXM, the card the port runs on, and the
dry run's roofline terms.

Port of ``repro/launch/roofline.py``, re-derived from NVIDIA's H100 SXM
data sheet (dense rates, 700 W).  The autotuner (``tuning/measure.py``)
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

The dry run's terms (``Roofline``, from one rank's counts,
``launch/costs.py``), per step and per device, all priced at data-sheet
rates, none measured on a card:

  compute     = FLOPs / ``BF16_FLOPS``
  memory      = bytes / ``HBM_BW``
  collective  = bytes on groups inside one node / ``NVLINK_BW``
                + bytes on groups that span nodes / ``FABRIC_BW``

A group's ranks lie in one node when ``rank // GPUS_PER_NODE`` is the same
for all of them (ranks numbered row-major over the mesh, eight GPUs a
node).  On the production meshes every dim's group spans nodes: "model"
(16 consecutive ranks) two nodes, "data" (stride 16) sixteen, "pod"
(stride 256) two; so all their collective bytes are priced at
``FABRIC_BW``, the per-GPU rate of one 400 Gb/s NDR InfiniBand port
(NVIDIA ConnectX-7 data sheet; a DGX H100 has one a GPU).  NVLink's 450
GB/s each way (the hopper-kernels guide, 1) prices only groups within a
node (the tests' small worlds).  ``coll_breakdown`` stays keyed by
collective kind, as the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

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
# NVLink, each way a GPU, and the inter-node fabric a GPU (above)
NVLINK_BW = 450e9
FABRIC_BW = 50e9


@dataclasses.dataclass
class Roofline:
    """The reference's ``Roofline`` (the same fields, properties and
    ``to_dict`` keys), with ``coll_cross_bytes``: of ``coll_bytes``, those
    on groups that span nodes (priced at ``FABRIC_BW``)."""

    arch: str
    shape: str
    mesh: str
    flops: float                  # per-device FLOPs (counted)
    hbm_bytes: float              # per-device bytes the ops move (counted)
    coll_bytes: float             # per-device collective bytes (sum)
    coll_breakdown: Dict[str, int]
    model_flops: float            # analytic useful flops, per device
    peak_mem_bytes: Optional[float] = None
    coll_cross_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        inside = self.coll_bytes - self.coll_cross_bytes
        return inside / NVLINK_BW + self.coll_cross_bytes / FABRIC_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline lower bound on step time (no overlap assumption: max)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the useful model flops achieve at the bound."""
        if self.step_time == 0:
            return 0.0
        return (self.model_flops / self.step_time) / BF16_FLOPS

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "peak_mem_bytes": self.peak_mem_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_cross_bytes": self.coll_cross_bytes,
        }


def analyze(arch: str, shape: str, mesh_name: str, counts,
            model_flops_global: float, n_devices: int,
            peak_mem: Optional[float] = None) -> Roofline:
    """The roofline of one rank's ``costs.Counts`` (the reference's
    ``analyze`` of a compiled module)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, flops=counts.flops,
        hbm_bytes=counts.hbm_bytes,
        coll_bytes=float(sum(counts.coll.values())),
        coll_breakdown=dict(counts.coll),
        model_flops=model_flops_global / n_devices, peak_mem_bytes=peak_mem,
        coll_cross_bytes=float(counts.coll_cross_bytes))


def model_flops_global(cfg, shape) -> float:
    """Analytic 'useful' FLOPs per step: 6*N_active*tokens (train) or
    2*N_active*tokens (inference); attention-score flops excluded."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def save(r: Roofline, path: str) -> None:
    with open(path, "w") as f:
        json.dump(r.to_dict(), f, indent=2)
