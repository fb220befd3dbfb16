"""The benchmark's layout: what it loads, what its reference imports, that
new cells, configs and metrics are found by name, the schedule, the
trace's arithmetic and the yardstick's counts.

Run from the checkout's root:
    python -m pytest -q escoin_bench/tests
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from escoin_bench import harness, profiling, traffic, weights, yardstick
from escoin_bench.reference import cnn as ref

HERE = harness.HERE
ROOT = harness.ROOT
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                   str(ROOT / "src")]))
REFERENCE_FILES = ("reference/cnn.py", "weights.py", "judge.py",
                   "yardstick.py")


def _python(code: str, cwd: Path = ROOT, env=None) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         env=env or ENV, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(HERE / 'tests')!r})\n"
        "from test_escoin_bench_cells import run_tiny\n"
        "from escoin_bench import harness\n"
        "run_tiny('googlenet-ell-b64')\n"
        "print(harness.forbidden_modules())\n")
    assert _python(code) == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import escoin_bench.reference.cnn, escoin_bench.weights\n"
            "import escoin_bench.judge, escoin_bench.yardstick\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))\n")
    assert _python(code) == "[]"
    for rel in REFERENCE_FILES:
        for node in ast.walk(ast.parse((HERE / rel).read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro", "repro_torch",
                                               "jax"), (rel, n)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    """In a copy of the benchmark: a throwaway config, a cell on it and a
    metric that reads it are added as files and entries, nothing is
    edited, and the harness runs the cell and reads the metric."""
    shutil.copytree(HERE, tmp_path / "escoin_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "escoin_bench")
    cfg = json.loads((HERE / "configs" / "googlenet-ell.json").read_text())
    cfg["name"] = "throwaway-net"
    cfg["plan"] = "dense"
    (tmp_path / "escoin_bench/configs/throwaway-net.json").write_text(
        json.dumps(cfg))
    cell = json.loads((HERE / "workloads" / "googlenet-ell-b64.json")
                      .read_text())
    cell.update(name="throwaway-cell", config="throwaway-net")
    (tmp_path / "escoin_bench/workloads/throwaway-cell.json").write_text(
        json.dumps(cell))
    (tmp_path / "escoin_bench/metrics/throwaway_share.py").write_text(
        "def read(run):\n    return 100.0 * run.images / run.attempted\n")
    bench["configs"].append({"name": "throwaway-net", "source": "x",
                             "file": "escoin_bench/configs/"
                                     "throwaway-net.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "throwaway-cell",
                               "config": "throwaway-net",
                               "traffic": "offline_b64", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "throwaway_share", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "images_per_s",
                               "workloads": ["throwaway-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "src", tmp_path / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    after = _digests(tmp_path / "escoin_bench")
    assert {k: v for k, v in after.items() if k in before} == before
    code = (
        "import sys, time, json, torch\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'src')!r}]\n"
        "from escoin_bench import harness\n"
        f"assert harness.HERE == __import__('pathlib').Path("
        f"{str(tmp_path / 'escoin_bench')!r})\n"
        "cell = harness.cell_file('throwaway-cell')\n"
        "cell['traffic'].update(batch=2, image=32, batches=2)\n"
        "ctx = harness.Ctx(name='throwaway-cell', cell=cell,\n"
        "    config=harness.config_file(cell['config']), seed=7,\n"
        "    seconds=0.5, trace=True, device=torch.device('cpu'),\n"
        "    t_process=time.perf_counter())\n"
        "run = harness.driver(cell['driver']).run(ctx)\n"
        "line = harness.result_line(harness.benchmark(), 'throwaway-cell',\n"
        "    run, True, {'platform': 'cpu', 'kind': 'cpu', 'count': 1})\n"
        "print(json.dumps([line['correct'], line['metrics']]))\n")
    env = dict(os.environ, PYTHONPATH="")
    correct, metrics = json.loads(_python(code, cwd=tmp_path, env=env))
    assert correct
    assert metrics["throwaway_share"]["value"] == 100.0


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    args = ["escoin_bench/run.py", "--workload", "resnet50-tuned-b64",
            "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    # the benchmark's files alone, without the program, fail too
    shutil.copytree(HERE, tmp_path / "escoin_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, *args], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


def test_the_schedule_changes_order_not_work():
    a = traffic.open_loop(500.0, 10.0, [224, 200, 160], 32, 1.0, 1)
    b = traffic.open_loop(500.0, 10.0, [224, 200, 160], 32, 1.0,
                          2 ** 31 + 99)
    assert len(a) == len(b) == 5000
    ga, gb = (np.diff([x.t_s for x in s] + [10.0]) for s in (a, b))
    np.testing.assert_allclose(np.sort(ga), np.sort(gb), rtol=1e-9)
    assert not np.allclose(ga, gb)
    assert sorted(x.size for x in a) == sorted(x.size for x in b)
    assert all(0.0 <= x.t_s < 10.0 for x in a)
    assert a[0].t_s == 0.0 and abs(ga.mean() - 1 / 500.0) < 1e-9


def test_the_trace_is_read_into_busy_time_gaps_and_launching_ops():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0,
         "dur": 50, "args": {"External id": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution",
         "ts": 5, "dur": 30, "args": {"External id": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 60,
         "dur": 40, "args": {"External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "sm90_fprop", "ts": 10,
         "dur": 20, "args": {"External id": 1}},
        {"ph": "X", "cat": "kernel", "name": "bsr_conv_tc_kernel",
         "ts": 25, "dur": 15, "args": {}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90,
         "dur": 10, "args": {"External id": 2}},
    ]
    t = profiling.parse(ev, window_s=200e-6)
    assert abs(t.busy_s - 40e-6) < 1e-12           # [10, 40] and [90, 100]
    assert [g[0] for g in t.gaps] == ["aten::copy_"]
    assert abs(t.gaps[0][1] - 50e-6) < 1e-12
    conv = profiling.launched_by(t, ("aten::cudnn_convolution",))
    assert abs(conv - 20e-6) < 1e-12
    assert abs(profiling.named(t, "bsr_conv") - 15e-6) < 1e-12
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["sm90_fprop", conv]
    assert bd["idle_gaps"] == [["aten::copy_", t.gaps[0][1]]]


def test_the_yardstick_counts_the_nets_useful_work():
    """2 x nonzeros x output pixels: ResNet-50 at 0.7 on its 39 pruned
    convs, GoogLeNet on its 49, at 224 px (the FC at full fan-in)."""
    for config, useful, dense in (("resnet50-tuned", 3.85e9, 7.71e9),
                                  ("googlenet-ell", 1.37e9, 3.16e9)):
        cfg = harness.config_file(config)
        convs, fcs = ref.walk_shapes(cfg["layers"], (3, 224, 224))
        assert sum(c["sparsity"] > 0 for c in convs) == cfg["pruned_convs"]
        w = weights.conv_weights(convs, 3, "cpu")
        nnz = {n: int((wb[0] != 0).sum()) for n, wb in w.items()}
        full = {c["name"]: c["m"] * c["c"] * c["k"] ** 2 for c in convs}
        got = yardstick.forward_flops(convs, nnz, fcs, 1)
        assert abs(got / useful - 1) < 0.01, got
        assert abs(yardstick.forward_flops(convs, full, fcs, 1) / dense
                   - 1) < 0.01
        c = convs[-1]
        assert yardstick.conv_bound_s(c, nnz[c["name"]], 64) == max(
            yardstick.conv_flops(c, nnz[c["name"]], 64) / 495e12,
            yardstick.conv_bytes(c, nnz[c["name"]], 64) / 3.35e12)


def test_set_up_refuses_a_program_network_other_than_the_table():
    from repro_torch.models import cnn

    from escoin_bench.systems import cnn as system

    cfg = harness.config_file("resnet50-tuned")
    system.check_program(cnn.resnet50(), cfg, (3, 224, 224))
    try:
        system.check_program(cnn.googlenet(), cfg, (3, 224, 224))
    except RuntimeError as exc:
        assert "differs from the configuration's table at layer 1" in str(exc)
    else:
        raise AssertionError("a different network was accepted")
