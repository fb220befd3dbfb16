"""Schedule rules: statically verify the card's kernel dispatch for a net.

Port of ``repro/analysis/schedule_rules.py``, retargeted to the card.  The
rules replay the port's own pure schedule probes,
``kernels.sparse_conv.ops.resolve_schedule`` and
``kernels.bsr_conv.ops.resolve_bsr_schedule``, with exactly the arguments
``CnnEngine`` hands them (``_op_report`` and the forward), over every conv
op a network can dispatch, without executing anything.  The invariant: a
plan entry is statically clean exactly when the engine resolves it without
raising and without a fallback.  Where the reference's kernels fall back,
the card's dispatch raises, naming the layer; every such finding is an
**error**, under the rule ``diagnostics.REASON_RULES`` maps the probe's
reason to.

Without a plan entry the same probes run as method-space coverage
(severity ``info``): which sparse methods this geometry could ever run.

Rules:

  sched.smem_budget      the kernel's stages bust a block's shared memory
                         (``budget.SMEM_MAX``)
  sched.unsupported_tm   a pinned ELL channel tile ``tm`` is not one of
                         the heights the source instantiates
                         (``budget.ELL_TILES``)
  sched.unsupported_tile no instantiated BCSR tile
                         (``budget.BSR_CONV_TILES``) holds whole block-rows
                         of this block height
  sched.unsupported_block a BCSR block shape the kernel does not take
                         (heights 8/16/32/64, width 128)
  sched.pipeline_demoted plan asks for the pipelined (double-buffered) ELL
                         schedule but its two stages do not fit, or the
                         conv is 1x1 (which stages nothing) -> the kernel
                         silently runs the blocking schedule (warning)
  sched.dtype_policy     geometry dtype outside the kernels' policy: the
                         card's conv launchers take f32 and bf16
                         activations (the reference's bf16/f32-in, f32-sum
                         policy), so a pallas/bsr entry at f16 is an error
                         (a deliberate difference: the reference's admits
                         f16)
  sched.halo_bounds      the conv's last window would read past the padded
                         input extent (the launchers' own check; an
                         invariant of the lowered geometry)
  sched.value_dtype      pinned value-storage dtype unknown, pinned on a
                         method with no quantised path, or not executable
                         on this backend (``tuning.space
                         .allowed_value_dtypes``: fp8 on ``cuda``, not on
                         ``cpu``)
  sched.value_dtype_mismatch
                         the plan's pinned value dtype disagrees with an
                         already-quantised bound bank -- the engine falls
                         back to dense with the ``value_dtype_mismatch``
                         runtime reason

The reference's ``sched.vmem_tiling`` has no counterpart (the card has no
VMEM), and its ``sched.nondividing_tm`` is ``sched.unsupported_tm`` here:
the ELL kernel covers a channel count that its tile does not divide.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.analysis.diagnostics import REASON_RULES, Diagnostic
from repro_torch.engine.program import ConvOp, Program
from repro_torch.kernels import budget
from repro_torch.kernels.bsr_conv.ops import resolve_bsr_schedule
from repro_torch.kernels.sparse_conv.ops import resolve_schedule
from repro_torch.tuning.space import VALUE_DTYPES, allowed_value_dtypes

RULES = {
    "sched.smem_budget": (
        "error",
        "the kernel's stages bust a block's shared memory",
    ),
    "sched.unsupported_tm": (
        "error",
        "pinned ELL channel tile is not one the kernel instantiates",
    ),
    "sched.unsupported_tile": (
        "error",
        "no instantiated kernel tile fits this block or pixel tile",
    ),
    "sched.unsupported_block": (
        "error",
        "BCSR block shape the kernel does not take",
    ),
    "sched.pipeline_demoted": (
        "warning",
        "planned pipelined ELL schedule does not fit (or the conv is 1x1); "
        "kernel silently runs the blocking schedule",
    ),
    "sched.dtype_policy": (
        "error",
        "dtype outside the card's bf16/f32-in, f32-accumulate conv kernels",
    ),
    "sched.halo_bounds": (
        "error",
        "the conv's last window reads past the padded input extent",
    ),
    "sched.value_dtype": (
        "error",
        "pinned value-storage dtype unknown, on a method with no quantised "
        "path, or not executable on this backend",
    ),
    "sched.value_dtype_mismatch": (
        "error",
        "plan's pinned value dtype disagrees with the already-quantised "
        "bound bank; the engine silently runs dense",
    ),
}

# Activation dtypes a lowered net may carry (the reference's policy), and
# the ones the card's conv kernels take (``kernels/*/kernel.py``: f32 and
# bf16; f16 would be a third instance of each kernel, not ported).
SUPPORTED_DTYPES = ("float32", "bfloat16", "float16")
KERNEL_DTYPES = ("float32", "bfloat16")


def itemsize(dtype: str) -> int:
    """Bytes an activation element of ``dtype`` takes (the reference's
    ``_itemsize``)."""
    return 2 if dtype in ("bfloat16", "float16") else 4

# The channel tiles ``tm`` the ELL kernel instantiates.
ELL_TMS = tuple(sorted({t for t, _ in budget.ELL_TILES}))

# Default BCSR block probed when no plan pins one (engine.DEFAULT_BSR_BLOCK;
# re-declared to keep this module import-light).
_DEFAULT_BLOCK = (8, 128)


def ell_schedule(op: ConvOp, *, batch: int, tm: Optional[int] = None,
                 pipeline: Optional[bool] = None, dtype: str = "float32"):
    """The ELL kernel's schedule for ``op``, as ``ops.sparse_conv`` asks
    for it at ``dtype`` activations: ``(EllSchedule, None)`` or ``(None,
    reason)``.  The bank's K does not enter the card's schedule (``c`` is
    given)."""
    return resolve_schedule(
        op.m, op.c, op.e, op.f, n=batch, c=op.c, r=op.k, s=op.k,
        stride=op.stride, hp=op.h + 2 * op.pad, wp=op.w + 2 * op.pad, tm=tm,
        pipeline=pipeline, itemsize=itemsize(dtype))


def bsr_schedule(op: ConvOp, bm: int, bn: int, *, batch: int,
                 value_dtype: str = "float32", dtype: str = "float32"):
    """The BCSR kernel's schedule for ``op`` blocked at (bm, bn) at
    ``dtype`` activations, as ``ops.bsr_conv`` asks for it: M padded to
    whole block-rows, the C*R*S columns."""
    gbm = -(-op.m // bm)
    return resolve_bsr_schedule(bm, bn, op.e, op.f, n=batch, m=gbm * bm,
                                crs=op.c * op.k * op.k,
                                value_dtype=value_dtype,
                                itemsize=itemsize(dtype))


def _halo_check(op: ConvOp, *, net: Optional[str]) -> List[Diagnostic]:
    """Invariant: the conv's last window stays inside the padded input
    (what both launchers check before a launch)."""
    hp, wp = op.h + 2 * op.pad, op.w + 2 * op.pad
    eh = (op.e - 1) * op.stride + op.k
    ew = (op.f - 1) * op.stride + op.k
    if eh <= hp and ew <= wp:
        return []
    return [Diagnostic(
        rule="sched.halo_bounds", severity="error",
        message=(f"output {op.e}x{op.f} at stride {op.stride} reads "
                 f"{eh}x{ew} of the padded input {hp}x{wp}"),
        net=net, layer=op.name)]


def _dtype_check(dtype: str, method: str, *, net: Optional[str],
                 layer: str) -> List[Diagnostic]:
    if dtype in KERNEL_DTYPES:
        return []
    return [Diagnostic(
        rule="sched.dtype_policy", severity="error",
        message=(f"plan pins {method} at {dtype} activations, but the "
                 f"card's conv kernels take {KERNEL_DTYPES} only"),
        net=net, layer=layer)]


def check_value_dtype(
    entry: Any,
    *,
    backend: str,
    bank_dtype: Optional[str] = None,
    net: Optional[str] = None,
    layer: Optional[str] = None,
    location: Optional[str] = None,
) -> List[Diagnostic]:
    """Value-dtype policy for one pallas/bsr plan entry.

    ``sched.value_dtype``: the pinned dtype is unknown, or ``backend``
    cannot execute it (``allowed_value_dtypes``, the planner's own
    candidate table, so planner and verifier never disagree about what is
    runnable).  ``sched.value_dtype_mismatch``: the bound bank is already
    quantised at a different dtype than the plan pins (``bank_dtype``, when
    the caller has params in hand), the configuration the engine refuses
    with the ``value_dtype_mismatch`` fallback.  An f32 bank under a narrow
    plan is healthy (the engine quantises it once) and reports nothing.
    """
    vdt = getattr(entry, "value_dtype", None) or "float32"
    if vdt not in VALUE_DTYPES:
        return [Diagnostic(
            rule="sched.value_dtype", severity="error",
            message=(f"plan pins unknown value dtype {vdt!r}; one of "
                     f"{VALUE_DTYPES}"),
            net=net, layer=layer, location=location)]
    allowed = allowed_value_dtypes(backend)
    if vdt not in allowed:
        return [Diagnostic(
            rule="sched.value_dtype", severity="error",
            message=(f"plan pins value dtype {vdt!r} but backend "
                     f"{backend!r} only executes {allowed}"),
            net=net, layer=layer, location=location)]
    if bank_dtype is not None and bank_dtype not in ("float32", vdt):
        return [Diagnostic(
            rule="sched.value_dtype_mismatch", severity="error",
            message=(f"plan pins value dtype {vdt!r} but the bound bank is "
                     f"already quantised as {bank_dtype!r}; the engine falls "
                     f"back to dense (value_dtype_mismatch)"),
            net=net, layer=layer, location=location)]
    return []


def _bank_dtype(bank: Any) -> Optional[str]:
    """The value-storage dtype of a bound bank (None without one)."""
    if bank is None:
        return None
    if getattr(bank, "scale", None) is None:
        return "float32"
    return bank.value_dtype


def _params_entry(params: Optional[Dict[str, Any]], op: ConvOp):
    return (params.get(op.name) or {}) if params is not None else {}


def check_pallas_entry(
    op: ConvOp,
    entry: Any,
    *,
    net: Optional[str] = None,
    batch: int = 1,
    dtype: str = "float32",
    backend: str = "cuda",
    params: Optional[Dict[str, Any]] = None,
) -> List[Diagnostic]:
    """Verify that a plan entry pinning ``method="pallas"`` has an ELL
    kernel schedule on the card (else the engine raises)."""
    pentry = _params_entry(params, op)
    bank = pentry.get("ell_auto") or pentry.get("ell")
    out = check_value_dtype(entry, backend=backend,
                            bank_dtype=_bank_dtype(bank), net=net,
                            layer=op.name)
    out = out or _dtype_check(dtype, "pallas", net=net, layer=op.name)
    if out:
        return out
    sched, reason = ell_schedule(op, batch=batch, tm=entry.tm,
                                 pipeline=entry.pipeline, dtype=dtype)
    if sched is None:
        return [Diagnostic(
            rule=REASON_RULES[reason], severity="error",
            message=(f"plan pins pallas (tm={entry.tm} pipeline="
                     f"{entry.pipeline}) but the card's ELL kernel has no "
                     f"schedule: {reason}"),
            net=net, layer=op.name)]
    if entry.pipeline and not sched.pipeline:
        why = ("a 1x1 conv stages nothing" if op.k == 1 else
               "its two stages do not fit a block's shared memory")
        out.append(Diagnostic(
            rule="sched.pipeline_demoted", severity="warning",
            message=(f"plan asks for the pipelined schedule but {why} at "
                     f"(tm={sched.tm}, tp={sched.tp}); the kernel runs the "
                     f"blocking schedule"),
            net=net, layer=op.name))
    return out + _halo_check(op, net=net)


def check_bsr_entry(
    op: ConvOp,
    entry: Any,
    *,
    net: Optional[str] = None,
    batch: int = 1,
    dtype: str = "float32",
    backend: str = "cuda",
    params: Optional[Dict[str, Any]] = None,
) -> List[Diagnostic]:
    """Verify that a plan entry pinning ``method="bsr"`` has a BCSR kernel
    schedule on the card (else the engine raises) and is not a stale entry
    the engine runs dense."""
    bank = _params_entry(params, op).get("bcsr_auto")
    if bank is not None and entry.block_m is not None and bank.block != (
            entry.block_m, entry.block_n):
        # the engine blocks an f32 bank from the dense weights instead
        bank = None
    out = check_value_dtype(entry, backend=backend,
                            bank_dtype=_bank_dtype(bank), net=net,
                            layer=op.name)
    if out:
        return out
    if entry.block_m is None or entry.block_n is None:
        # a stale pre-v5 entry: the engine runs dense with
        # engine_reason="stale_plan_no_block"
        return [Diagnostic(
            rule="plan.stale_bsr_no_block", severity="error",
            message=("plan pins bsr with no block shape (stale pre-v5 "
                     "entry); the engine silently falls back to dense"),
            net=net, layer=op.name)]
    out = _dtype_check(dtype, "bsr", net=net, layer=op.name)
    if out:
        return out
    bm, bn = int(entry.block_m), int(entry.block_n)
    vdt = getattr(entry, "value_dtype", None) or "float32"
    sched, reason = bsr_schedule(op, bm, bn, batch=batch, value_dtype=vdt,
                                 dtype=dtype)
    if sched is None:
        return [Diagnostic(
            rule=REASON_RULES[reason], severity="error",
            message=(f"plan pins bsr (block={bm}x{bn}, {vdt}) but the "
                     f"card's BCSR kernel has no schedule: {reason}"),
            net=net, layer=op.name)]
    return _halo_check(op, net=net)


def _probe_methods(op: ConvOp, *, net: Optional[str], batch: int,
                   dtype: str) -> List[Diagnostic]:
    """Method-space coverage for an unplanned sparse conv: report (info)
    every sparse method this geometry can never dispatch on the card."""
    out: List[Diagnostic] = []
    if dtype not in KERNEL_DTYPES:
        return [Diagnostic(
            rule="sched.dtype_policy", severity="info",
            message=(f"methods pallas and bsr unavailable at {dtype} "
                     f"activations (the card's conv kernels take "
                     f"{KERNEL_DTYPES})"),
            net=net, layer=op.name)]
    sched, reason = ell_schedule(op, batch=batch, dtype=dtype)
    if sched is None:
        out.append(Diagnostic(
            rule=REASON_RULES[reason], severity="info",
            message=f"method pallas unavailable for this geometry: {reason}",
            net=net, layer=op.name))
    bm, bn = _DEFAULT_BLOCK
    sched, reason = bsr_schedule(op, bm, bn, batch=batch, dtype=dtype)
    if sched is None:
        out.append(Diagnostic(
            rule=REASON_RULES[reason], severity="info",
            message=(f"method bsr unavailable at the default {bm}x{bn} "
                     f"block: {reason}"),
            net=net, layer=op.name))
    return out


def check_network(
    program: Program,
    plan: Optional[Dict[str, Any]] = None,
    *,
    net: Optional[str] = None,
    batch: int = 1,
    dtype: str = "float32",
    backend: str = "cuda",
    params: Optional[Dict[str, Any]] = None,
) -> List[Diagnostic]:
    """Schedule-verify every conv op of a lowered program.

    ``plan`` is a ``{layer_name: PlanEntry}`` table (what ``CnnEngine``
    binds); ops it pins to ``pallas``/``bsr`` are verified to have a kernel
    schedule on the card (error otherwise).  Unplanned sparse ops get
    method-space coverage probes at severity ``info``.
    """
    if dtype not in SUPPORTED_DTYPES:
        return [Diagnostic(
            rule="sched.dtype_policy", severity="error",
            message=(f"dtype {dtype!r} outside the activation policy "
                     f"{SUPPORTED_DTYPES}"),
            net=net)]
    out: List[Diagnostic] = []
    kw = dict(net=net, batch=batch, dtype=dtype, backend=backend,
              params=params)
    for op in program.conv_ops:
        if op.sparsity <= 0:
            continue  # dense-kept layer: only ever runs dense
        entry = (plan or {}).get(op.name)
        if entry is None:
            out += _probe_methods(op, net=net, batch=batch, dtype=dtype)
        elif entry.method == "pallas":
            out += check_pallas_entry(op, entry, **kw)
        elif entry.method == "bsr":
            out += check_bsr_entry(op, entry, **kw)
        elif entry.tm is not None and entry.tm not in ELL_TMS:
            # Other methods ignore tm, but a tile the ELL kernel lacks in
            # the entry signals a stale or mis-keyed plan.
            out.append(Diagnostic(
                rule="sched.unsupported_tm", severity="warning",
                message=(f"plan entry carries tm={entry.tm}, not one of the "
                         f"ELL kernel's {ELL_TMS} (stale or mis-keyed "
                         f"plan?)"),
                net=net, layer=op.name))
    return out
