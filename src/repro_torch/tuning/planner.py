"""Network-level planner: plan a lowered engine program, per conv op.

Port of ``repro/tuning/planner.py``.  The planner turns the candidate space
(``space.py``) plus a scoring mode (``measure.py``) into a ``{layer_name:
PlanEntry}`` plan, consulting and filling a persistent
:class:`~repro_torch.tuning.cache.PlanCache` so tuning runs once per
deployment.  It walks the engine's flat lowered program, every geometry
(the fused epilogue included) already resolved.

Identical geometries (repeated ResNet bottlenecks) share one key and are
scored once a run even without a persistent cache.  Plans scored with the
layer's weights in hand carry a structure tag in their key
(``weight_structure_tag``), and the legacy-inherit rules decide when an
untagged entry may serve them.  ``CnnEngine`` runs the plan through
``method="auto"``.  The backend in the key is ``"cuda"`` on the card and
``"cpu"`` on the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.core.sparse_format import (bcsr_conv_from_dense,
                                            ell_from_dense,
                                            ell_from_dense_conv,
                                            quantize_values)
from repro_torch.engine import ConvOp, Program, lower
from repro_torch.tuning.cache import PlanCache, PlanEntry, layer_key
from repro_torch.tuning.measure import (bcsr_true_kept, measurable,
                                        measure_candidate, roofline_estimate)
from repro_torch.tuning.space import (ConvGeometry, allowed_value_dtypes,
                                      enumerate_candidates)

_LOG = logging.getLogger("repro_torch.tuning")


def backend_of(device) -> str:
    """The plan-cache backend of a device: ``"cuda"`` or ``"cpu"``."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def geometry_for(layer, c: int, h: int, w: int, *, batch: int = 1,
                 dtype: str = "float32", relu: bool = False,
                 residual: bool = False) -> ConvGeometry:
    """Geometry from a raw layer spec (no epilogue flags unless given)."""
    return ConvGeometry(
        name=layer.name, m=layer.out_c, c=c, h=h, w=w, r=layer.k, s=layer.k,
        stride=layer.stride, pad=layer.pad, sparsity=layer.sparsity,
        batch=batch, dtype=dtype, relu=relu, residual=residual)


def geometry_of_op(op: ConvOp, *, batch: int = 1,
                   dtype: str = "float32") -> ConvGeometry:
    """Geometry from a lowered ``ConvOp``, with its fused epilogue (ReLU,
    bottleneck shortcut) in the cache key and the ``fuse`` axis."""
    return ConvGeometry(
        name=op.name, m=op.m, c=op.c, h=op.h, w=op.w, r=op.k, s=op.k,
        stride=op.stride, pad=op.pad, sparsity=op.sparsity, batch=batch,
        dtype=dtype, relu=op.fuse_relu, residual=op.res is not None)


def plan_layer(g: ConvGeometry, *, mode: str = "roofline",
               w_dense: Optional[np.ndarray] = None, backend: str = "cpu",
               device=None, warmup: int = 1, iters: int = 3,
               quantize: bool = False) -> PlanEntry:
    """Score every valid candidate for one layer and return the winner.

    ``w_dense`` is required in wall mode (the candidates run on it, on
    ``device``, default the backend's) and used by roofline mode when given
    (``bsr`` priced from the bank's true kept tiles).  ``quantize=True``
    opts into the narrow value dtypes ``backend`` can run: lossy, so never
    a default.  On ties the first candidate wins.
    """
    cands = enumerate_candidates(
        g, value_dtypes=(allowed_value_dtypes(backend) if quantize
                         else ("float32",)))
    if mode == "wall":
        cands = [cd for cd in cands if measurable(cd, backend)]
    if not cands:
        return PlanEntry(method="dense", source="heuristic",
                         provenance="default")
    best, best_t = None, float("inf")
    x = None
    if mode == "wall":
        if w_dense is None:
            raise ValueError("wall-mode tuning needs the layer's dense weights")
        rng = np.random.default_rng(0)
        dev = resolve_device(device if device is not None else
                             ("cuda" if backend == "cuda" else "cpu"))
        x = torch.from_numpy(rng.standard_normal(
            (g.batch, g.c, g.h, g.w)).astype(np.float32)).to(dev)
    kept_by_block: Dict[Any, float] = {}
    for cd in cands:
        if mode == "wall":
            t = measure_candidate(g, cd, w_dense, x, warmup=warmup,
                                  iters=iters)
            _LOG.debug("wall %s %s: p50=%.1fus min=%.1fus max=%.1fus",
                       g.name, cd, t * 1e6, t.min * 1e6, t.max * 1e6)
        elif cd.method == "bsr" and w_dense is not None:
            blk = (cd.block_m or 8, cd.block_n or 128)
            if blk not in kept_by_block:
                kept_by_block[blk] = bcsr_true_kept(w_dense, *blk)
            t = roofline_estimate(g, cd, bsr_kept=kept_by_block[blk])
        else:
            t = roofline_estimate(g, cd)
        if t < best_t:
            best, best_t = cd, t
    if mode == "wall":
        _LOG.info("wall winner %s %s: p50=%.1fus spread=[%.1fus, %.1fus]",
                  g.name, best.method, best_t * 1e6,
                  getattr(best_t, "min", best_t) * 1e6,
                  getattr(best_t, "max", best_t) * 1e6)
    return PlanEntry(method=best.method, tm=best.tm, pad_to=best.pad_to,
                     te=best.te, tf=best.tf, fuse=best.fuse,
                     pipeline=best.pipeline, permute=best.permute,
                     block_m=best.block_m, block_n=best.block_n,
                     value_dtype=best.value_dtype, est_s=float(best_t),
                     source="measured" if mode == "wall" else "roofline")


def weight_structure_tag(w_dense: np.ndarray) -> str:
    """Cache-key component of a weights-aware plan: the bank's kept-tile
    fraction at the default (8, 128) block, bucketed to 10%, so a
    block-pruned bank's ``bsr`` plan never serves an unstructured bank of
    the same geometry."""
    w = np.asarray(w_dense)
    gbn = max(1, -(-(int(np.prod(w.shape[1:]))) // 128))
    frac = bcsr_true_kept(w, 8, 128) / gbn
    return f"bk{min(1.0, round(frac, 1))}"


def _dense_weights(params: Optional[Dict[str, Any]], op: ConvOp):
    if op.sparsity <= 0 or params is None or op.name not in params:
        return None
    w = params[op.name]["w"]
    return w.detach().cpu().numpy() if isinstance(w, torch.Tensor) \
        else np.asarray(w)


def plan_program(program: Program, *, batch: int = 1,
                 dtype: str = "float32", mode: str = "roofline",
                 cache: Optional[PlanCache] = None,
                 params: Optional[Dict[str, Any]] = None,
                 backend: Optional[str] = None, device=None,
                 warmup: int = 1, iters: int = 3,
                 quantize: bool = False) -> Dict[str, PlanEntry]:
    """Tune every conv op of a lowered program; returns name -> PlanEntry.

    Cache hits skip scoring; misses are scored, written back, and saved to
    ``cache.path`` when it is set.  Duplicate layer keys are scored once a
    run.  ``backend`` defaults to ``device``'s (default the card).
    ``mode="roofline"`` uses ``params`` when given; ``mode="wall"`` needs
    them and measures on ``device``.  ``quantize=True`` opts into the
    narrow value dtypes (see :func:`plan_layer`).  With telemetry on, the
    ``tuning.plan.*`` counters record where each entry came from.
    """
    if mode not in ("roofline", "wall"):
        raise ValueError(f"unknown tuning mode {mode!r}")
    if backend is None:
        backend = backend_of(resolve_device(
            "cuda" if device is None else device))
    plan: Dict[str, PlanEntry] = {}
    scored: Dict[str, PlanEntry] = {}
    misses = 0
    for op in program.conv_ops:
        g = geometry_of_op(op, batch=batch, dtype=dtype)
        w_dense = _dense_weights(params, op)
        base_key = key = layer_key(g, backend)
        if w_dense is not None:
            # weights-aware scores depend on the bank's block structure
            key += "_" + weight_structure_tag(w_dense)
        telem = telemetry.is_enabled()
        entry = cache.get(key) if cache is not None else None
        if entry is not None and telem:
            telemetry.counter(f"tuning.plan.{entry.provenance}").inc()
        if entry is None and cache is not None and key != base_key:
            # An untagged (legacy or weight-free) entry: only bsr pricing is
            # structure-sensitive, so a non-bsr winner is inherited and a
            # bsr one re-scored.
            legacy = cache.get(base_key)
            if legacy is not None and legacy.method != "bsr":
                entry = dataclasses.replace(legacy, provenance="migrated")
                if telem:
                    telemetry.counter("tuning.plan.legacy_inherit").inc()
            elif legacy is not None and telem:
                telemetry.counter("tuning.plan.bsr_structure_rescore").inc()
        if entry is None:
            entry = scored.get(key)
            if entry is not None and telem:
                telemetry.counter("tuning.plan.dedup_hit").inc()
        if entry is None:
            if op.sparsity <= 0:
                entry = PlanEntry(method="dense", source="heuristic",
                                  provenance="default")
            else:
                if mode == "wall" and w_dense is None:
                    raise ValueError(
                        f"wall-mode tuning needs params for {op.name}")
                entry = plan_layer(g, mode=mode, w_dense=w_dense,
                                   backend=backend, device=device,
                                   warmup=warmup, iters=iters,
                                   quantize=quantize)
            misses += 1
            scored[key] = entry
            if telem:
                telemetry.counter("tuning.plan.scored").inc()
            if cache is not None:
                cache.put(key, entry)
        plan[op.name] = entry
    if cache is not None and cache.path and misses:
        cache.save()
    return plan


def plan_network(net: Sequence[Any], in_c: int, image: int, *,
                 batch: int = 1, **kw) -> Dict[str, PlanEntry]:
    """Lower the spec once, then :func:`plan_program`."""
    program = lower(net, (in_c, image, image))
    return plan_program(program, batch=batch, **kw)


def apply_plan_to_params(params: Dict[str, Any],
                         plan: Dict[str, PlanEntry]) -> Dict[str, Any]:
    """Rebuild per-layer sparse formats at each plan's knobs, beside the
    defaults, on each layer's device: ``ell2d_auto`` (lowered),
    ``ell_auto`` (csr-direct, pallas; nnz-balanced for a ``permute`` entry,
    quantised for a narrow ``value_dtype``), ``bcsr_auto`` (bsr, blocked at
    the plan's shape, quantised for a narrow dtype; an entry with no block
    shape, a stale pre-v5 plan, is skipped and the engine runs it dense).
    Safe to call repeatedly."""
    for name, pe in plan.items():
        entry = params.get(name)
        if entry is None or "ell" not in entry:
            continue  # dense-kept layer: nothing to rebuild
        pad_to = pe.pad_to or 8
        dev = entry["w"].device
        w = entry["w"].detach().cpu().numpy()
        if pe.method == "lowered":
            entry["ell2d_auto"] = ell_from_dense(
                w.reshape(w.shape[0], -1), pad_to=pad_to, device=dev)
        elif pe.method in ("csr-direct", "pallas"):
            bank = ell_from_dense_conv(
                w, pad_to=pad_to,
                balance=pe.method == "pallas" and pe.permute, device=dev)
            if pe.method == "pallas" and pe.value_dtype != "float32":
                bank = quantize_values(bank, pe.value_dtype)
            entry["ell_auto"] = bank
        elif (pe.method == "bsr" and pe.block_m is not None
              and pe.block_n is not None):
            bank = bcsr_conv_from_dense(w, block=(pe.block_m, pe.block_n),
                                        device=dev)
            if pe.value_dtype != "float32":
                bank = quantize_values(bank, pe.value_dtype)
            entry["bcsr_auto"] = bank
    return params


def format_plan(plan: Dict[str, PlanEntry]) -> str:
    """Human-readable per-layer plan table (the paper's customization
    table)."""
    lines = [f"{'layer':<22} {'method':<11} {'tm':>4} {'te':>4} {'tf':>4} "
             f"{'pad_to':>6} {'block':>8} {'fuse':>5} {'pipe':>5} {'perm':>5} "
             f"{'vdtype':>8} {'est_us':>10} source"]
    for name, pe in plan.items():
        block = (f"{pe.block_m}x{pe.block_n}"
                 if pe.block_m and pe.block_n else "-")
        vdt = {"float32": "f32", "float8_e4m3fn": "fp8"}.get(
            pe.value_dtype, pe.value_dtype)
        lines.append(
            f"{name:<22} {pe.method:<11} {pe.tm or '-':>4} "
            f"{pe.te or '-':>4} {pe.tf or '-':>4} "
            f"{pe.pad_to or '-':>6} {block:>8} {'y' if pe.fuse else '-':>5} "
            f"{'y' if pe.pipeline else '-':>5} "
            f"{'y' if pe.permute else '-':>5} "
            f"{vdt:>8} "
            f"{pe.est_s * 1e6:>10.1f} {pe.source}")
    return "\n".join(lines)
