"""Pre-flight checker: orchestrate every rule pack over nets and caches.

Port of ``repro/analysis/checker.py``.  ``run_check`` is what the CLI and
CI call: for each requested network it lowers the spec, runs the program
rules, resolves the plan cache (when given) into the ``{layer_name:
PlanEntry}`` table the engine would bind, and schedule-verifies every conv
op against the card's probes; plan-cache files are also audited on their
own (every entry, whether or not a net maps to it); the CUDA kernel
sources get the lints (``cuda_lints``).

``preflight`` is the engine's strict-mode hook: verify one bound (program,
plan, params) triple and return the diagnostics;
``CnnEngine(..., strict=True)`` raises :class:`PreflightError` on errors,
and ``RobustCnnServer`` drops a ladder rung that has any.
"""
from __future__ import annotations

import glob
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis import (cuda_lints, plan_rules, program_rules,
                                  schedule_rules)
from repro_torch.analysis.diagnostics import Diagnostic, Report

DEFAULT_NETS = ("alexnet", "googlenet", "resnet50")

# Rule catalogue across every pack: id -> (default severity, one-liner).
ALL_RULES = {}
for _pack in (schedule_rules, plan_rules, program_rules, cuda_lints):
    ALL_RULES.update(_pack.RULES)


def _repo_root() -> str:
    # src/repro_torch/analysis/checker.py -> the repo root is four up
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def default_plan_path(net: str) -> Optional[str]:
    """The shipped default plan for a net (``plans/<net>.json``), if any.
    Its keys name backend ``cpu``: under ``--backend cuda`` it is audited
    as a file and resolves no entries."""
    path = os.path.join(_repo_root(), "plans", f"{net}.json")
    return path if os.path.exists(path) else None


def default_kernel_paths() -> List[str]:
    """The port's CUDA kernel sources (``kernels/*/csrc/*.cu``)."""
    base = os.path.join(_repo_root(), "src", "repro_torch", "kernels")
    return sorted(glob.glob(os.path.join(base, "*", "csrc", "*.cu")))


def default_backend() -> str:
    """The backend a bind would run on by default: the card when there is
    one (the port's entry points default to ``device="cuda"``), else
    ``cpu``."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve_plan(program, cache_path: str, *, batch: int, dtype: str,
                 backend: str) -> Dict[str, Any]:
    """The ``{layer_name: PlanEntry}`` table this net would bind from a
    cache file: the same key lookup ``tuning.planner.plan_program`` does
    without params, minus the scoring (unmatched layers stay unplanned)."""
    from repro_torch.tuning.cache import (PlanCache, PlanCacheWarning,
                                          layer_key)
    from repro_torch.tuning.planner import geometry_of_op

    cache = PlanCache()
    with warnings.catch_warnings():
        # File-level problems are reported by plan_rules.check_plan_file;
        # here we only want whatever entries are salvageable.
        warnings.simplefilter("ignore", PlanCacheWarning)
        if os.path.exists(cache_path):
            cache.load(cache_path)
    plan: Dict[str, Any] = {}
    for op in program.conv_ops:
        g = geometry_of_op(op, batch=batch, dtype=dtype)
        entry = cache.get(layer_key(g, backend))
        if entry is not None:
            plan[op.name] = entry
    return plan


def check_network(net: str, *, plan_cache: Optional[str] = None,
                  batch: int = 1, image: int = 224, dtype: str = "float32",
                  backend: str = "cpu") -> List[Diagnostic]:
    """Program + schedule rules for one named network."""
    from repro_torch.engine import lower
    from repro_torch.models import cnn

    if net not in cnn.NETWORKS:
        return [Diagnostic(
            rule="prog.out_undefined", severity="error",
            message=f"unknown network {net!r}; one of {sorted(cnn.NETWORKS)}",
            net=net)]
    program = lower(cnn.NETWORKS[net](), (3, image, image))
    out = program_rules.check_program(program, net=net)
    plan = None
    if plan_cache:
        plan = resolve_plan(program, plan_cache, batch=batch, dtype=dtype,
                            backend=backend)
    out += schedule_rules.check_network(program, plan, net=net, batch=batch,
                                        dtype=dtype, backend=backend)
    return out


def run_check(nets: Optional[Sequence[str]] = None,
              plan_caches: Optional[Sequence[str]] = None, *,
              batch: int = 1, image: int = 224, dtype: str = "float32",
              backend: str = "cpu",
              lint_paths: Optional[Sequence[str]] = None,
              lints: bool = True) -> Report:
    """The full pre-flight sweep; what ``python -m repro_torch.analysis
    check`` runs.

    ``plan_caches=None`` audits each net's shipped default plan
    (``plans/<net>.json``) when present; pass an explicit list to audit
    specific files (each is both audited on its own and resolved against
    every requested net).  ``backend`` is the key component resolved
    (default ``cpu``, the shipped plans' key) and the backend whose value
    dtypes the rules allow.
    """
    report = Report()
    nets = list(nets) if nets else list(DEFAULT_NETS)
    explicit_caches = plan_caches is not None
    cache_list = list(plan_caches) if explicit_caches else []
    audited = set()
    for net in nets:
        net_caches = ((cache_list or [None]) if explicit_caches
                      else [default_plan_path(net)])
        for cache_path in net_caches:
            if cache_path and cache_path not in audited:
                audited.add(cache_path)
                report.extend(plan_rules.check_plan_file(cache_path))
                report.checked.append(f"plan:{os.path.basename(cache_path)}")
            report.extend(check_network(
                net, plan_cache=cache_path, batch=batch, image=image,
                dtype=dtype, backend=backend))
        report.checked.append(f"net:{net}")
    if lints:
        paths = list(lint_paths) if lint_paths else default_kernel_paths()
        report.extend(cuda_lints.check_paths(paths))
        report.checked.append(f"lint:{len(paths)} kernel file(s)")
    return report


def preflight(program, plan: Optional[Dict[str, Any]],
              params: Optional[Dict[str, Any]] = None, *, batch: int = 1,
              dtype: str = "float32",
              backend: Optional[str] = None) -> List[Diagnostic]:
    """Verify one bound (program, plan, params) triple: the engine's
    strict-mode hook.  Pure Python over shapes and plan entries; returns
    the diagnostics (the engine raises on any error-severity finding).

    ``backend`` is the one the bind executes on: the engine passes its
    device's type (``"cuda"`` or ``"cpu"``); ``None`` takes
    :func:`default_backend`.  It gates, e.g., an fp8-pinned entry reaching
    a ``cpu`` bind."""
    if backend is None:
        backend = default_backend()
    out = program_rules.check_program(program)
    out += schedule_rules.check_network(program, plan, batch=batch,
                                        dtype=dtype, backend=backend,
                                        params=params)
    return out
