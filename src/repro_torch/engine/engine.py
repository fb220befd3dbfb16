"""CnnEngine: bind params (and a tuned plan) to a lowered program and run it
on the card.

Port of ``repro/engine/engine.py``, all six methods: ``dense``,
``lowered``, ``csr-direct``, ``pallas``, ``bsr`` and ``auto``, the last one
plan-driven (``repro_torch.tuning``).  The program runs eagerly, op by op:
PyTorch needs no trace to dispatch the kernels, and this slice keeps
``torch.compile`` off the path (CUDA graphs are later work).  FC weights are
created once at bind time from each ``FCOp``'s static fan-in, exactly as the
reference draws them.

Conv epilogues (``bias → ReLU`` and the bottleneck ``bias → +shortcut →
ReLU``) were fused into ``ConvOp`` at lowering time; ``pallas`` and ``bsr``
run them in-kernel unless ``fuse=False`` (or a plan entry) says otherwise,
the other methods as the reference's unfused op sequence.  ``pallas`` is
the ELL direct sparse conv kernel's method name, kept from the reference so
method names compare across the two packages.

``method="auto"`` takes each conv's method, tiles, bank layout and value
storage from the plan (a roofline plan computed per batch when none is
bound).  A plan entry the card's kernel cannot run raises, naming the
layer and the reason; the reference would fall back.  Two decisions about
a plan are the engine's own and fall back to ``dense`` exactly as on the
reference, through ``record_fallback``: a ``bsr`` entry with no block
shape (``stale_plan_no_block``) and a value dtype the bound bank cannot
give (``value_dtype_mismatch``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device, telemetry
from repro_torch.core.direct_conv import dense_conv, direct_sparse_conv
from repro_torch.core.lowering import lowered_sparse_conv
from repro_torch.core.pruning import magnitude_prune
from repro_torch.core.sparse_format import (balance_ell_conv,
                                            bcsr_conv_from_dense,
                                            ell_from_dense,
                                            ell_from_dense_conv,
                                            quantize_values)
from repro_torch.engine.program import (ConcatOp, ConvOp, FCOp, PoolOp,
                                        Program, ReluOp, ResidualAddOp)
from repro_torch.kernels.bsr_conv.kernel import split_weights
from repro_torch.kernels.bsr_conv.ops import bsr_conv, resolve_bsr_schedule
from repro_torch.kernels.sparse_conv.ops import (apply_epilogue, pack_indices,
                                                 resolve_schedule,
                                                 sparse_conv)
from repro_torch.telemetry.fallback import record_fallback
from repro_torch.telemetry.report import ExecutionReport, OpReport

METHODS = ("dense", "lowered", "csr-direct", "pallas", "bsr", "auto")

# Default BCSR tile shape for a direct ``method="bsr"`` call (no plan
# pinning one); the autotuner picks per layer from the block ladder.
DEFAULT_BSR_BLOCK = (8, 128)


class NoKernelSchedule(ValueError):
    """A plan pins an ELL or BCSR entry the card's kernel has no schedule
    for: where the reference would fall back, the port refuses.
    ``refused`` lists ``(layer, reason)`` for every such conv op of the
    forward, ``reason`` the schedule probe's code (``unsupported_tm``,
    ``unsupported_block``, ``smem_infeasible``, ...)."""

    def __init__(self, message: str, refused):
        super().__init__(message)
        self.refused = list(refused)


@dataclasses.dataclass
class _Decision:
    """One conv op's resolved dispatch knobs: what the plan (or the caller)
    asked for, before the kernel's own schedule.  Shared by ``_conv`` and
    ``execution_report``, so the report never disagrees with what runs."""

    auto: bool                    # method="auto" (plan-driven) call
    pe: Any                       # the PlanEntry consulted (None without)
    method: str                   # method to execute
    method_planned: str           # what the plan/caller asked for
    tm: Optional[int]
    pipeline: Optional[bool]
    permute: bool
    fuse: bool
    block: Optional[Tuple[int, int]]
    value_dtype: str              # value-storage dtype the kernel streams
    quantize_in_forward: bool     # f32 bank, narrow plan: quantise here
    engine_reason: Optional[str]  # stale bsr plan, value-dtype mismatch
    provenance: str


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
    """Program + params (+ plan) -> eager executor on ``device`` (default
    the card).

    ``engine(x, method)`` runs the bound program on ``x`` (moved to the
    engine's device as f32).  ``plan`` is a ``{layer_name: PlanEntry}``
    table from ``repro_torch.tuning``; ``method="auto"`` with no plan bound
    computes a roofline plan per batch size on first use, priced from the
    bound weights.  ``fuse=None`` runs the kernels' epilogue in-kernel (and
    honours each plan entry's ``fuse`` under ``auto``), ``fuse=False``
    forces the unfused passes.

    What a forward derives from a bank is made on first use and kept on the
    engine: BCSR banks blocked from the dense weights (keyed on (layer,
    block)), a bank balanced or quantised for a plan that the params do not
    carry, the ELL banks' packed indices and the BCSR tiles' split halves
    (keyed on the layer, the bank's block or balance and its value dtype),
    so a forward launches none of that work after its first.

    ``strict=True`` runs the pre-flight static verifier at bind time
    (``repro_torch.analysis``), against this engine's device type: the
    lowered program is checked structurally and every plan-pinned ELL or
    BCSR entry is verified to have a kernel schedule on the card (else
    its forward would raise) and not to fall back; any error raises
    :class:`repro_torch.analysis.PreflightError` here instead.
    """

    def __init__(self, program: Program, params: Dict[str, Any],
                 plan: Optional[Dict[str, Any]] = None, *,
                 strict: bool = False, device="cuda"):
        self.program = program
        self.params = params
        self.plan = plan
        self.device = resolve_device(device)
        if strict:
            from repro_torch.analysis import PreflightError  # cycle
            from repro_torch.analysis.checker import preflight
            from repro_torch.tuning.planner import backend_of
            errors = [d for d in preflight(program, plan, params,
                                           backend=backend_of(self.device))
                      if d.severity == "error"]
            if errors:
                raise PreflightError(errors)
        self.fc_weights = self._bind_fc(program, params, self.device)
        self._auto_plans: Dict[int, Dict[str, Any]] = {}
        self._bcc_cache: Dict[Any, Any] = {}
        self._derived: Dict[Any, Any] = {}
        self._halves_cache: Dict[Any, Any] = {}
        self._packed_cache: Dict[Any, torch.Tensor] = {}
        # (method, shape, fuse, plan) configurations already run: the
        # reports' ``jit_cache_hit`` and the engine.jit_* counters, as the
        # reference counts its compiles (here the first forward of a
        # configuration builds the banks it derives)
        self._seen: set = set()
        # The ExecutionReport of the most recent telemetry-enabled (or
        # timed) forward.
        self.last_report: Optional[ExecutionReport] = None

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

    def _auto_plan(self, batch: int) -> Dict[str, Any]:
        plan = self._auto_plans.get(batch)
        if plan is None:
            from repro_torch.tuning.planner import (backend_of,  # cycle
                                                    plan_program)
            # the bound params price bsr from each layer's real kept tiles
            plan = plan_program(self.program, batch=batch, mode="roofline",
                                params=self.params,
                                backend=backend_of(self.device))
            self._auto_plans[batch] = plan
        return plan

    # -- what a forward derives from a bank, made once ---------------------

    def _kept(self, cache: Dict[Any, Any], key, src, make):
        """``make()`` for ``key``, made once while ``src`` (the bank it
        derives from) stays the same object."""
        hit = cache.get(key)
        if hit is None or hit[0] is not src:
            hit = (src, make())
            cache[key] = hit
        return hit[1]

    def _packed_for(self, op: ConvOp, ell) -> torch.Tensor:
        """The ELL bank's packed indices, keyed on (layer, balanced, value
        dtype)."""
        key = (op.name, ell.perm is not None, ell.value_dtype)
        return self._kept(self._packed_cache, key, ell,
                          lambda: pack_indices(ell))

    def _bcsr_for(self, op: ConvOp, entry: Dict[str, Any], block=None):
        """The BCSR bank this op runs: the prebuilt ``bcsr_auto`` when its
        block matches, else one blocked on the host from the dense weights,
        once per (layer, block)."""
        bcc = entry.get("bcsr_auto")
        if bcc is not None and (block is None or bcc.block == block):
            return bcc
        block = block or DEFAULT_BSR_BLOCK
        key = (op.name, block)
        bcc = self._bcc_cache.get(key)
        if bcc is None:
            bcc = bcsr_conv_from_dense(entry["w"].cpu().numpy(), block=block,
                                       device=self.device)
            self._bcc_cache[key] = bcc
        return bcc

    def _halves_for(self, op: ConvOp, bcc) -> Any:
        """An f32 bank's tiles split into the BCSR kernel's TF32 halves,
        keyed on (layer, block, value dtype); a quantised bank has none."""
        if bcc.scale is not None:
            return None
        key = (op.name, bcc.block, bcc.value_dtype)
        return self._kept(self._halves_cache, key, bcc,
                          lambda: split_weights(bcc.blocks))

    def _ell_bank(self, op: ConvOp, entry: Dict[str, Any], d: _Decision):
        """The ELL bank an op runs: the plan's prebuilt ``ell_auto`` under
        ``auto``, else ``ell``; balanced and quantised here (once) where the
        plan asks for what the params do not carry."""
        ell = entry.get("ell_auto", entry.get("ell")) if d.auto \
            else entry.get("ell")
        if ell is None or d.method != "pallas":
            return ell
        if d.permute and ell.perm is None:
            ell = self._kept(self._derived, (op.name, "balance"), ell,
                             lambda: balance_ell_conv(ell))
        if d.quantize_in_forward and ell.scale is None:
            src = ell
            ell = self._kept(self._derived,
                             (op.name, "quantize", d.value_dtype,
                              src.perm is not None), src,
                             lambda: quantize_values(src, d.value_dtype))
        return ell

    def _bcsr_bank(self, op: ConvOp, entry: Dict[str, Any], d: _Decision):
        bcc = self._bcsr_for(op, entry, d.block)
        if d.quantize_in_forward and bcc.scale is None:
            src = bcc
            bcc = self._kept(self._derived,
                             (op.name, "quantize", d.value_dtype, src.block),
                             src, lambda: quantize_values(src, d.value_dtype))
        return bcc

    # -- dispatch decisions ------------------------------------------------

    def _plan_decision(self, op: ConvOp, method: str, plan,
                       fuse_override: Optional[bool]) -> _Decision:
        """Resolve one conv op's dispatch knobs from the plan (or the
        caller's direct method), as the reference resolves them."""
        auto = method == "auto"
        tm = None
        pipeline = None  # the ELL schedule pipelines where it fits
        permute = False
        block = None     # bsr: None = any prebuilt bank (or the default)
        fuse = True if fuse_override is None else fuse_override
        pe = None
        engine_reason = None
        provenance = "direct"
        if auto:
            pe = (plan or {}).get(op.name)
            method = pe.method if pe is not None else "dense"
            provenance = pe.provenance if pe is not None else "default"
            if pe is not None:
                tm = pe.tm
                pipeline, permute = pe.pipeline, pe.permute
                if fuse_override is None:
                    fuse = pe.fuse
                if method == "bsr":
                    if pe.block_m is None or pe.block_n is None:
                        # a stale plan predating the v5 schema
                        method = "dense"
                        engine_reason = "stale_plan_no_block"
                    else:
                        block = (pe.block_m, pe.block_n)
        method_planned = pe.method if (auto and pe is not None) else (
            "dense" if auto else method)
        value_dtype = "float32"
        quantize_in_forward = False
        if auto and pe is not None and method in ("pallas", "bsr"):
            # What the plan pinned vs what the bound bank stores: equal ->
            # run the bank; f32 bank + narrow plan -> quantise it here; any
            # other mismatch is a stale plan: dense, and say so.
            want = pe.value_dtype
            entry = self.params.get(op.name, {})
            if method == "pallas":
                bank = entry.get("ell_auto", entry.get("ell"))
            else:
                bank = entry.get("bcsr_auto")
                if bank is not None and not (block is None
                                             or bank.block == block):
                    bank = None  # _bcsr_for blocks f32 from the weights
            have = ("float32" if bank is None or bank.scale is None
                    else bank.value_dtype)
            if want == have:
                value_dtype = want
            elif have == "float32":
                value_dtype = want
                quantize_in_forward = True
            else:
                method = "dense"
                engine_reason = "value_dtype_mismatch"
        return _Decision(auto=auto, pe=pe, method=method,
                         method_planned=method_planned, tm=tm,
                         pipeline=pipeline, permute=permute, fuse=fuse,
                         block=block, value_dtype=value_dtype,
                         quantize_in_forward=quantize_in_forward,
                         engine_reason=engine_reason, provenance=provenance)

    # -- execute ----------------------------------------------------------

    def _conv(self, op: ConvOp, x: torch.Tensor,
              res: Optional[torch.Tensor], method: str, plan,
              fuse_override: Optional[bool]) -> torch.Tensor:
        entry = self.params[op.name]
        d = self._plan_decision(op, method, plan, fuse_override)
        method, fuse = d.method, d.fuse
        if d.engine_reason is not None:
            record_fallback(
                "engine", d.engine_reason, layer=op.name,
                geometry=f"m={op.m} c={op.c} e={op.e} f={op.f}",
                fallback_to="dense")
        b = entry["b"]
        conv = dict(stride=op.stride, padding=op.pad)
        if op.sparsity == 0 or method == "dense":
            y = dense_conv(x, entry["w"], **conv)
        elif method == "lowered":
            ell2d = (entry.get("ell2d_auto", entry.get("ell2d")) if d.auto
                     else entry.get("ell2d"))
            y = lowered_sparse_conv(x, ell2d, op.k, op.k, **conv)
        elif method == "csr-direct":
            y = direct_sparse_conv(x, self._ell_bank(op, entry, d), **conv)
        elif method == "pallas":
            ell = self._ell_bank(op, entry, d)
            kw = dict(conv, tm=d.tm, pipeline=d.pipeline, layer=op.name,
                      packed_idx=self._packed_for(op, ell))
            if fuse:
                return sparse_conv(x, ell, bias=b, fuse_relu=op.fuse_relu,
                                   residual=res, **kw)
            y = sparse_conv(x, ell, **kw)
        elif method == "bsr":
            bcc = self._bcsr_bank(op, entry, d)
            kw = dict(conv, layer=op.name, halves=self._halves_for(op, bcc))
            if fuse:
                return bsr_conv(x, bcc, bias=b, fuse_relu=op.fuse_relu,
                                residual=res, **kw)
            y = bsr_conv(x, bcc, **kw)
        else:
            raise ValueError(method)
        # Unfused epilogue: the reference's op sequence.
        return apply_epilogue(y, b, op.fuse_relu, res)

    def _exec_op(self, op, vals: Dict[int, torch.Tensor], method: str, plan,
                 fuse_override: Optional[bool]) -> torch.Tensor:
        """Execute one program op against the value table."""
        if isinstance(op, ConvOp):
            res = vals[op.res] if op.res is not None else None
            return self._conv(op, vals[op.src], res, method, plan,
                              fuse_override)
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

    def _resolve(self, shape, method: str,
                 plan_override: Optional[Dict[str, Any]]):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; one of {METHODS}")
        plan = plan_override if plan_override is not None else self.plan
        if method == "auto" and plan is None:
            plan = self._auto_plan(int(shape[0]))
        return plan

    def __call__(self, x, method: str = "dense", *,
                 fuse: Optional[bool] = None,
                 plan_override: Optional[Dict[str, Any]] = None,
                 rung: Optional[str] = None) -> torch.Tensor:
        """Run the bound program; ``x`` is (N, C, H, W), array or tensor.

        ``plan_override`` runs another plan table for this call without
        rebinding; ``rung`` labels the forward's ExecutionReport (the
        serving tier's degradation ladder)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        plan = self._resolve(tuple(x.shape), method, plan_override)
        key = (method, tuple(x.shape), fuse, id(plan))
        hit = key in self._seen
        self._seen.add(key)
        if telemetry.is_enabled():
            # dispatch-time observation, from the same _plan_decision
            self._record_forward(tuple(x.shape), method, plan, fuse, hit,
                                 rung=rung)
        vals: Dict[int, torch.Tensor] = {0: x}
        with torch.no_grad():
            for op in self.program.ops:
                vals[op.out] = self._exec_op(op, vals, method, plan, fuse)
        return vals[self.program.out]

    # -- observability -----------------------------------------------------

    def _record_forward(self, shape, method: str, plan,
                        fuse_override: Optional[bool], hit: bool,
                        rung: Optional[str] = None) -> None:
        report = self._build_report(shape, "float32", method, plan,
                                    fuse_override, hit, rung=rung)
        self.last_report = report
        telemetry.counter("engine.forwards").inc()
        telemetry.counter(
            "engine.jit_hits" if hit else "engine.jit_misses").inc()
        if report.fallback_count:
            telemetry.counter("engine.fallback_ops").inc(
                report.fallback_count)
        report.emit_spans(telemetry.get_tracer())

    def _build_report(self, shape, dtype: str, method: str, plan,
                      fuse_override: Optional[bool],
                      hit: Optional[bool] = None,
                      rung: Optional[str] = None) -> ExecutionReport:
        batch = int(shape[0])
        report = ExecutionReport(
            method=method, batch=batch, in_shape=tuple(shape), dtype=dtype,
            jit_cache_hit=hit, plan_bound=self.plan is not None, rung=rung)
        refused = []
        for op in self.program.conv_ops:
            try:
                report.ops.append(self._op_report(
                    op, method, plan, fuse_override, batch=batch,
                    dtype=dtype))
            except NoKernelSchedule as exc:
                refused.append((str(exc), exc.refused))
        if refused:
            # every refused op, under the first one's message
            raise NoKernelSchedule(refused[0][0],
                                   [r for _, rs in refused for r in rs])
        return report

    def _op_report(self, op: ConvOp, method: str, plan,
                   fuse_override: Optional[bool], *, batch: int,
                   dtype: str) -> OpReport:
        """One conv op's OpReport: the dispatch decision and the schedule
        the kernel will run (its ``resolve_*`` probe, which raises where
        the kernel has none), with the roofline cost of that schedule."""
        from repro_torch.tuning.measure import candidate_cost  # cycle
        from repro_torch.tuning.planner import geometry_of_op
        from repro_torch.tuning.space import Candidate

        entry = self.params[op.name]
        d = self._plan_decision(op, method, plan, fuse_override)
        g = geometry_of_op(op, batch=batch, dtype=dtype)
        executed = "dense" if op.sparsity == 0 else d.method
        pad_to = d.pe.pad_to if d.pe is not None else None
        tiling: Dict[str, Any] = {}
        if executed == "pallas":
            # balancing or quantising a bank keeps its K
            ell = (entry.get("ell_auto", entry.get("ell")) if d.auto
                   else entry.get("ell"))
            sched, why = resolve_schedule(
                op.m, ell.k, op.e, op.f, n=batch, c=op.c, r=op.k, s=op.k,
                stride=op.stride, hp=op.h + 2 * op.pad,
                wp=op.w + 2 * op.pad, tm=d.tm, pipeline=d.pipeline)
            if sched is None:
                raise NoKernelSchedule(
                    f"layer {op.name}: the plan's ELL schedule (tm={d.tm}) "
                    f"has no kernel on this card ({why})", [(op.name, why)])
            tiling = dataclasses.asdict(sched)
        elif executed == "bsr":
            bcc = self._bcsr_for(op, entry, d.block)
            gbm, _, bm, bn = bcc.blocks.shape
            sched, why = resolve_bsr_schedule(
                bm, bn, op.e, op.f, n=batch, m=gbm * bm,
                crs=op.c * op.k * op.k, value_dtype=d.value_dtype)
            if sched is None:
                raise NoKernelSchedule(
                    f"layer {op.name}: the plan's BCSR block ({bm}, {bn}) "
                    f"has no kernel on this card ({why})", [(op.name, why)])
            tiling = {"n_tile": sched[0], "wgs": sched[1], "block_m": bm,
                      "block_n": bn}
        vdtype = d.value_dtype if executed in ("pallas", "bsr") else "float32"
        cand = Candidate(
            method=executed, tm=tiling.get("tm"), pad_to=pad_to,
            fuse=d.fuse if executed in ("pallas", "bsr") else False,
            pipeline=bool(tiling.get("pipeline", False)),
            permute=d.permute if executed == "pallas" else False,
            block_m=tiling.get("block_m"), block_n=tiling.get("block_n"),
            value_dtype=vdtype)
        w = entry["w"].detach().cpu().numpy() if executed == "bsr" else None
        cost = candidate_cost(g, cand, w_dense=w)
        return OpReport(
            name=op.name, method_planned=d.method_planned,
            method_executed=executed, provenance=d.provenance,
            plan_source=d.pe.source if d.pe is not None else "-",
            fallback_reason=d.engine_reason, fuse=d.fuse, tiling=tiling,
            sparsity=op.sparsity, value_dtype=vdtype, **cost)

    def execution_report(self, x, method: str = "auto", *,
                         fuse: Optional[bool] = None,
                         plan_override: Optional[Dict[str, Any]] = None,
                         rung: Optional[str] = None) -> ExecutionReport:
        """The ExecutionReport a forward with these arguments would produce,
        built without running anything: ``x`` is the input or its shape.
        Raises :class:`NoKernelSchedule` where the forward would raise (a
        plan entry the card's kernels cannot run), naming every such op."""
        shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
        plan = self._resolve(shape, method, plan_override)
        hit = (method, shape, fuse, id(plan)) in self._seen
        return self._build_report(shape, "float32", method, plan, fuse, hit,
                                  rung=rung)

    def forward_timed(self, x, method: str = "auto", *,
                      fuse: Optional[bool] = None) -> torch.Tensor:
        """Timed mode: run op by op, each op between two CUDA events on the
        card (the host clock, after the op, on the CPU) and inside
        ``torch.profiler.record_function(name)``, so a profile maps its
        kernels back to layer names; each op's time goes to the tracer's
        ``wall`` lane, and the report, with every conv's ``wall_s``, to
        ``self.last_report``.  A profiling tool, not a serving path: it
        synchronises once, at the end, and records whatever the telemetry
        switch says."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        plan = self._resolve(tuple(x.shape), method, None)
        report = self._build_report(tuple(x.shape), "float32", method, plan,
                                    fuse)
        report.timed = True
        tracer = telemetry.get_tracer()
        cuda = self.device.type == "cuda"
        spans = []
        vals: Dict[int, torch.Tensor] = {0: x}
        with torch.no_grad():
            for op in self.program.ops:
                name = (getattr(op, "name", None)
                        or f"{type(op).__name__}:{op.out}")
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    if cuda:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        vals[op.out] = self._exec_op(op, vals, method, plan,
                                                     fuse)
                        end.record()
                        spans.append((op, name, t0, (start, end)))
                    else:
                        vals[op.out] = self._exec_op(op, vals, method, plan,
                                                     fuse)
                        spans.append((op, name, t0,
                                      time.perf_counter() - t0))
        if cuda:
            torch.cuda.synchronize(self.device)
        walls: Dict[str, float] = {}
        for op, name, t0, dt in spans:
            if cuda:
                dt = dt[0].elapsed_time(dt[1]) / 1e3
            tracer.complete(name, start_s=t0, dur_s=dt, cat="op.timed",
                            tid=telemetry.TID_WALL,
                            args={"kind": type(op).__name__})
            if isinstance(op, ConvOp):
                walls[op.name] = dt
        for o in report.ops:
            o.wall_s = walls.get(o.name)
        self.last_report = report
        return vals[self.program.out]
