"""The PyTorch port stands alone: no module under ``src/repro_torch/``, and
not ``chip_smoke.py`` or ``compare_conv.py``, imports ``jax`` or anything
of the JAX package ``repro``.  ``repro_torch`` and its submodules are the
port's own.

An AST scan, so imports inside functions count too.  The same scan finds
a module-level function or class defined twice in one of these files: the
second silently replaces the first for every caller.
"""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "compare_conv.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_port_has_modules_to_scan():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/kernels/sparse_conv/kernel.py" in names
    assert "src/repro_torch/kernels/bsr_conv/kernel.py" in names
    assert "src/repro_torch/kernels/bsr_matmul/kernel.py" in names
    assert "src/repro_torch/kernels/flash_attention/kernel.py" in names
    assert "src/repro_torch/serving/scheduler.py" in names
    for module in ("optim/adamw.py", "optim/schedule.py", "data/pipeline.py",
                   "checkpoint/store.py", "runtime/fault_tolerance.py",
                   "launch/train.py", "launch/steps.py", "tree.py"):
        assert f"src/repro_torch/{module}" in names
    for module in ("analysis/__init__.py", "analysis/__main__.py",
                   "analysis/diagnostics.py", "analysis/program_rules.py",
                   "analysis/schedule_rules.py", "analysis/plan_rules.py",
                   "analysis/cuda_lints.py", "analysis/checker.py",
                   "analysis/cli.py", "serving/robust.py", "serving/chaos.py",
                   "examples/cnn_inference.py"):
        assert f"src/repro_torch/{module}" in names
    # the model families: every config module of the reference, the layers
    # (MLA, MoE, Mamba2) and the LLM serving example
    for arch in ("deepseek_v3_671b", "olmoe_1b_7b", "jamba_1_5_large_398b",
                 "qwen1_5_0_5b", "qwen1_5_4b", "mistral_large_123b", "yi_9b",
                 "hubert_xlarge", "mamba2_2_7b", "phi_3_vision_4_2b"):
        assert f"src/repro_torch/configs/{arch}.py" in names
    for module in ("models/layers.py", "models/transformer.py",
                   "models/flags.py", "examples/serve_sparse_llm.py"):
        assert f"src/repro_torch/{module}" in names
    # the multi-chip path: sharding rules and collectives, the mesh
    # constructors and input specs, the elastic re-mesh, the int8 cross-pod
    # all-reduce, expert parallelism
    for module in ("distributed/__init__.py", "distributed/sharding.py",
                   "distributed/collectives.py", "launch/mesh.py",
                   "launch/specs.py", "runtime/elastic.py",
                   "optim/compression.py", "models/moe_ep.py"):
        assert f"src/repro_torch/{module}" in names
    # the dry run on the fake process group, its counters and roofline
    for module in ("launch/dryrun.py", "launch/costs.py", "launch/enrich.py",
                   "launch/roofline.py"):
        assert f"src/repro_torch/{module}" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source, bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import lax", True), ("from repro.core import x", True),
    ("import repro.kernels", True), ("from repro import telemetry", True),
    ("import importlib\nimportlib.import_module('jax')", True),
    ("from repro_torch.core import x", False), ("import repro_torch", False),
    ("import torch", False), ("from . import budget", False)])
def test_scanner_tells_the_port_from_the_reference(source, bad):
    found = [m for _, m in _imported_modules(ast.parse(source))
             if _forbidden(m)]
    assert bool(found) == bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_each_top_level_function_is_defined_once(path):
    names = [node.name for node in ast.parse(path.read_text()).body
             if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))]
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice, f"{path.name} defines {twice} more than once"
