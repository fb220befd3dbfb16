"""Finding a cell's pieces by name, and the run's one result line.

``BENCHMARK.json`` (at the checkout's root) names the cells and metrics;
each cell's own file (``workloads/<cell>.json``) names its config, its
driver and its traffic; each per-layer metric is a reader
(``metrics/<metric>.py``).  Nothing here changes when a cell, a config or
a metric is added.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the port must not load: the JAX stack and the
# JAX package the port was made from (compared whole: repro_torch is not
# repro).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_file(name: str, here: Path = HERE) -> Dict[str, Any]:
    return load_json(here / "workloads" / f"{name}.json")


def config_file(name: str, here: Path = HERE) -> Dict[str, Any]:
    return load_json(here / "configs" / f"{name}.json")


def load_module(path: Path, label: str):
    """Import one file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: Path = HERE):
    return load_module(here / "drivers" / f"{name}.py",
                       f"escoin_bench_driver_{name}")


def reader(name: str, here: Path = HERE) -> Callable[["Run"], Optional[float]]:
    return load_module(here / "metrics" / f"{name}.py",
                       f"escoin_bench_metric_{name.replace('.', '_')}").read


def _applies(metric: Dict[str, Any], cell: str) -> Optional[bool]:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return None


def end_to_end_metrics(bench: Dict[str, Any], cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell) is not False]


def per_layer_metrics(bench: Dict[str, Any], cell: str) -> List[Dict]:
    """The cell's per-layer metrics: those that list it, and those that
    list no cells and move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        hit = _applies(m, cell)
        if hit or (hit is None and m["moves"] in e2e):
            out.append(m)
    return out


@dataclasses.dataclass
class Ctx:
    """What a driver is given: the cell, its config, the run's arguments.

    ``engine_hook`` wraps the engine(s) the window drives (``None`` in a
    benchmark run; the tests break the timed path through it).
    ``t_process`` is the host clock when the process began: set-up runs
    from there to the window's start."""

    name: str
    cell: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float
    engine_hook: Optional[Callable[[Any], Any]] = None


@dataclasses.dataclass
class Run:
    """What a driver hands back: the end-to-end numbers it took, what the
    per-layer readers read, and the comparison with the reference."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]   # name -> (value, limit)
    ok: bool                                   # every other condition held
    memory_peak_bytes: int
    window_s: float
    images: int = 0
    flops_per_image: float = 0.0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    layers: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    forwards_traced: int = 0
    trace: Any = None                          # profiling.Trace
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.ok and all(v <= lim for v, lim in self.checks.values())


def forbidden_modules() -> List[str]:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def _finite(v: float) -> float:
    return float(v) if math.isfinite(v) else 1e300


def result_line(bench: Dict[str, Any], name: str, run: Run, trace: bool,
                device: Dict[str, Any]) -> Dict[str, Any]:
    """The run's result object, its keys in the order the driver reads."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in per_layer_metrics(bench, name):
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in end_to_end_metrics(bench, name):
            if m["name"] not in run.e2e:
                raise KeyError(f"{name}: the driver took no {m['name']}")
            metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                  "unit": m["unit"]}
    dev = dict(device, memory_peak_bytes=int(run.memory_peak_bytes))
    out: Dict[str, Any] = {"correct": run.correct, "attempted": run.attempted,
                           "failed": run.failed, "metrics": metrics,
                           "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": _finite(v), "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out
