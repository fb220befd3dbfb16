"""CnnEngine: bind params to a lowered program and execute it on the card.

Port of ``repro/engine/engine.py`` for the methods ``dense``, ``lowered``,
``csr-direct``, ``pallas`` and ``bsr``.  The program runs eagerly, op by op:
PyTorch needs no trace to dispatch the kernels, and this slice keeps
``torch.compile`` off the path (CUDA graphs are later work).  FC weights are
created once at bind time from each ``FCOp``'s static fan-in, exactly as the
reference draws them.

Conv epilogues (``bias → ReLU`` and the bottleneck ``bias → +shortcut →
ReLU``) were fused into ``ConvOp`` at lowering time; ``pallas`` and ``bsr``
run them in-kernel, the other methods as the reference's unfused op
sequence.  ``pallas`` is the ELL direct sparse conv kernel's method name,
kept from the reference so method names compare across the two packages.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.direct_conv import dense_conv, direct_sparse_conv
from repro_torch.core.lowering import lowered_sparse_conv
from repro_torch.core.pruning import magnitude_prune
from repro_torch.core.sparse_format import (bcsr_conv_from_dense,
                                            ell_from_dense,
                                            ell_from_dense_conv)
from repro_torch.engine.program import (ConcatOp, ConvOp, FCOp, PoolOp,
                                        Program, ReluOp, ResidualAddOp)
from repro_torch.kernels.bsr_conv.kernel import split_weights
from repro_torch.kernels.bsr_conv.ops import bsr_conv
from repro_torch.kernels.sparse_conv.ops import (apply_epilogue, pack_indices,
                                                 sparse_conv)

METHODS = ("dense", "lowered", "csr-direct", "pallas", "bsr", "auto")

# Default BCSR tile shape for ``method="bsr"``.
DEFAULT_BSR_BLOCK = (8, 128)

AUTO_NOT_PORTED = (
    "method='auto' dispatches through the autotuner's plans, which the "
    "PyTorch port has not reached yet (ROADMAP.md, Queue 1 item 6: "
    "autotuner); pass one of 'dense', 'lowered', 'csr-direct', 'pallas', "
    "'bsr'")


def _conv_entry(w: np.ndarray, b: np.ndarray, sparse: bool,
                device: torch.device) -> Dict[str, Any]:
    entry = {"w": torch.from_numpy(w).to(device),
             "b": torch.from_numpy(b).to(device)}
    if sparse:
        entry["ell"] = ell_from_dense_conv(w, device=device)
        entry["ell2d"] = ell_from_dense(w.reshape(w.shape[0], -1),
                                        device=device)
    return entry


def init_conv_params(program: Program, rng: np.random.Generator,
                     device="cuda") -> Dict[str, Any]:
    """Random pruned weights for every conv of a lowered program.

    Draws in ``conv_table`` order with the reference's formulas, then one
    integer for the FC weight stream, so the weights equal the reference's
    from the same generator (pruning masks up to threshold ties, see
    ``core/pruning.py``).  Each conv gets ``w`` and ``b`` and, when pruned,
    its ``ell``/``ell2d`` banks, all on ``device``.
    """
    dev = resolve_device(device)
    params: Dict[str, Any] = {}
    for l, (c, _, _) in program.conv_table:
        w = (rng.standard_normal((l.out_c, c, l.k, l.k))
             .astype(np.float32) * (2.0 / (c * l.k * l.k)) ** 0.5)
        if l.sparsity > 0:
            w = magnitude_prune(w, l.sparsity)
        params[l.name] = _conv_entry(w, np.zeros((l.out_c,), np.float32),
                                     l.sparsity > 0, dev)
    params["_fc_rng"] = rng.integers(0, 2**31)
    return params


def params_from_reference(np_params: Dict[str, Any],
                          device="cuda") -> Dict[str, Any]:
    """The reference's params, as numpy, bound for the port.

    ``np_params`` holds ``{"w", "b"}`` per conv layer plus ``_fc_rng``.  The
    banks are rebuilt with the port's own builders, so both packages compute
    from the same arrays: a layer whose weights hold a zero was pruned and
    gets ``ell``/``ell2d`` (BCSR banks are built on demand by the engine).
    """
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for name, entry in np_params.items():
        if name == "_fc_rng":
            out[name] = int(entry)
            continue
        w = np.array(entry["w"], dtype=np.float32)   # a writable copy
        b = np.array(entry["b"], dtype=np.float32)
        out[name] = _conv_entry(w, b, bool((w == 0).any()), dev)
    return out


def _pool(op: PoolOp, x: torch.Tensor) -> torch.Tensor:
    if op.kind == "gap":
        return x.mean(dim=(2, 3), keepdim=True)
    if op.kind == "max":
        return F.max_pool2d(x, op.k, op.stride, op.pad)
    # the reference sums over a zero-padded window and divides by k*k
    return F.avg_pool2d(x, op.k, op.stride, op.pad, count_include_pad=True)


class CnnEngine:
    """Program + params -> eager executor on ``device`` (default the card).

    ``engine(x, method)`` runs the bound program on ``x`` (moved to the
    engine's device as f32).  ``method="bsr"`` blocks each pruned layer's
    dense weights into a ``DEFAULT_BSR_BLOCK`` bank on first use and caches
    it on the engine with its tiles split into the kernel's bf16 halves; ``method="pallas"`` likewise packs each ELL bank's
    indices once.
    """

    def __init__(self, program: Program, params: Dict[str, Any],
                 device="cuda"):
        self.program = program
        self.params = params
        self.device = resolve_device(device)
        self.fc_weights = self._bind_fc(program, params, self.device)
        self._bcc_cache: Dict[Any, Any] = {}
        self._halves_cache: Dict[str, Any] = {}
        self._packed_cache: Dict[str, torch.Tensor] = {}

    # -- bind -------------------------------------------------------------

    @staticmethod
    def _bind_fc(program: Program, params: Dict[str, Any],
                 device: torch.device) -> Dict[Any, torch.Tensor]:
        """FC weights keyed on ``(name, in_f)``, drawn in program order from
        the ``_fc_rng`` seed as the reference draws them."""
        rng = np.random.default_rng(int(params.get("_fc_rng", 0)))
        out: Dict[Any, torch.Tensor] = {}
        for op in program.fc_ops:
            w = (rng.standard_normal((op.in_f, op.out_f))
                 .astype(np.float32) * (1.0 / op.in_f) ** 0.5)
            out[(op.name, op.in_f)] = torch.from_numpy(w).to(device)
        return out

    def _packed_for(self, op: ConvOp, entry: Dict[str, Any]) -> torch.Tensor:
        """The layer's packed ELL indices, packed on first use and cached, so
        a forward launches no packing ops."""
        packed = self._packed_cache.get(op.name)
        if packed is None:
            packed = pack_indices(entry["ell"])
            self._packed_cache[op.name] = packed
        return packed

    def _bcsr_for(self, op: ConvOp, entry: Dict[str, Any]):
        """The layer's BCSR bank, blocked from its dense weights on the host
        on first use and cached."""
        bcc = self._bcc_cache.get(op.name)
        if bcc is None:
            bcc = bcsr_conv_from_dense(entry["w"].cpu().numpy(),
                                       block=DEFAULT_BSR_BLOCK,
                                       device=self.device)
            self._bcc_cache[op.name] = bcc
        return bcc

    def _halves_for(self, op: ConvOp, bcc) -> Any:
        """The bank's tiles split into the BCSR kernel's bf16 halves, split
        on first use and cached, so a forward launches no splitting ops."""
        halves = self._halves_cache.get(op.name)
        if halves is None:
            halves = split_weights(bcc.blocks)
            self._halves_cache[op.name] = halves
        return halves

    # -- execute ----------------------------------------------------------

    def _conv(self, op: ConvOp, x: torch.Tensor,
              res: Optional[torch.Tensor], method: str) -> torch.Tensor:
        entry = self.params[op.name]
        b = entry["b"]
        if op.sparsity == 0 or method == "dense":
            y = dense_conv(x, entry["w"], stride=op.stride, padding=op.pad)
        elif method == "lowered":
            y = lowered_sparse_conv(x, entry["ell2d"], op.k, op.k,
                                    stride=op.stride, padding=op.pad)
        elif method == "csr-direct":
            y = direct_sparse_conv(x, entry["ell"], stride=op.stride,
                                   padding=op.pad)
        elif method == "pallas":
            return sparse_conv(x, entry["ell"], stride=op.stride,
                               padding=op.pad, bias=b,
                               fuse_relu=op.fuse_relu, residual=res,
                               layer=op.name,
                               packed_idx=self._packed_for(op, entry))
        elif method == "bsr":
            bcc = self._bcsr_for(op, entry)
            return bsr_conv(x, bcc, stride=op.stride, padding=op.pad, bias=b,
                            fuse_relu=op.fuse_relu, residual=res,
                            layer=op.name, halves=self._halves_for(op, bcc))
        else:
            raise ValueError(method)
        # Unfused epilogue: the reference's op sequence.
        return apply_epilogue(y, b, op.fuse_relu, res)

    def _exec_op(self, op, vals: Dict[int, torch.Tensor],
                 method: str) -> torch.Tensor:
        """Execute one program op against the value table."""
        if isinstance(op, ConvOp):
            res = vals[op.res] if op.res is not None else None
            return self._conv(op, vals[op.src], res, method)
        if isinstance(op, ReluOp):
            return torch.relu(vals[op.src])
        if isinstance(op, PoolOp):
            return _pool(op, vals[op.src])
        if isinstance(op, ConcatOp):
            return torch.cat([vals[s] for s in op.srcs], dim=1)
        if isinstance(op, ResidualAddOp):
            y = vals[op.a] + vals[op.b]
            return torch.relu(y) if op.fuse_relu else y
        if isinstance(op, FCOp):
            flat = vals[op.src].reshape(vals[op.src].shape[0], -1)
            return flat @ self.fc_weights[(op.name, op.in_f)]
        raise TypeError(f"unknown op {op!r}")

    def _execute(self, x: torch.Tensor, method: str) -> torch.Tensor:
        vals: Dict[int, torch.Tensor] = {0: x}
        for op in self.program.ops:
            vals[op.out] = self._exec_op(op, vals, method)
        return vals[self.program.out]

    def __call__(self, x, method: str = "dense") -> torch.Tensor:
        """Run the bound program; ``x`` is (N, C, H, W), array or tensor."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; one of {METHODS}")
        if method == "auto":
            raise NotImplementedError(AUTO_NOT_PORTED)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self._execute(x, method)
