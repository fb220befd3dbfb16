"""The benchmark's cells on the CPU at a small image size: the port's
plain path against the frozen reference, the control that has to fail,
and the timed path broken underneath, which has to come out not correct.

Run from the checkout's root:
    python -m pytest -q escoin_bench/tests
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from escoin_bench import harness, judge

OFFLINE = ("resnet50-tuned-b64", "googlenet-ell-b64")
SERVE = ("resnet50-tuned-serve", "googlenet-ell-serve")
SEED = 2 ** 31 + 12345


def tiny_cell(name: str) -> dict:
    """The cell at 32 px (serving: 32/28/24 px into buckets of 32 and 24,
    two images a batch, a deadline and a latency limit no CPU tick
    reaches)."""
    cell = harness.cell_file(name)
    tr = cell["traffic"]
    if cell["driver"] == "offline":
        tr.update(batch=2, image=32, batches=3, trace_forwards=2)
    else:
        tr.update(rate=4.0, sizes=[32, 28, 24], buckets=[32, 24],
                  bucket_batch=2, deadline_s=600.0, slo_ms=600e3,
                  pool_per_size=2, trace_seconds=1.0)
    return cell


def run_tiny(name: str, hook=None, trace: bool = False,
             here=harness.HERE) -> harness.Run:
    cell = tiny_cell(name)
    ctx = harness.Ctx(name=name, cell=cell,
                      config=harness.config_file(cell["config"], here),
                      seed=SEED, seconds=1.0, trace=trace,
                      device=torch.device("cpu"),
                      t_process=time.perf_counter(), engine_hook=hook)
    return harness.driver(cell["driver"], here).run(ctx)


@pytest.mark.parametrize("name", OFFLINE + SERVE)
def test_cell_agrees_with_the_reference(name):
    trace = name in ("resnet50-tuned-b64", "googlenet-ell-serve")
    run = run_tiny(name, trace=trace)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    value, limit = run.checks["logit_err"]
    assert value < limit / 10
    if name in SERVE:
        assert run.e2e["goodput_images_per_s"] > 0
    line = harness.result_line(harness.benchmark(), name, run, False,
                               {"platform": "cpu", "kind": "cpu",
                                "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    e2e = {m["name"] for m in harness.end_to_end_metrics(
        harness.benchmark(), name)}
    assert set(line["metrics"]) == e2e
    json.dumps(line, allow_nan=False)
    if trace:
        # every per-layer metric the cell lists, but those the device's
        # trace gives (the CPU has none)
        bench = harness.benchmark()
        line = harness.result_line(bench, name, run, True,
                                   {"platform": "cpu", "kind": "cpu",
                                    "count": 1})
        want = {m["name"] for m in harness.per_layer_metrics(bench, name)
                if m["source"] != "device_trace"}
        assert set(line["metrics"]) == want
        json.dumps(line, allow_nan=False)


class _Broken:
    """The engine with one fault where its answers are produced."""

    def __init__(self, engine, fault: str):
        self.engine, self.fault, self.last = engine, fault, None

    def __call__(self, *args, **kw):
        y = self.engine(*args, **kw).clone()
        if self.fault == "stale":
            y, self.last = (y if self.last is None else self.last), y
        elif self.fault == "half_batch":
            half = (y.shape[0] + 1) // 2
            y[half:] = y[:half].mean(dim=0)
        elif self.fault == "altered":
            y[0, 0] += 0.01 * y[0].abs().max()
        return y


@pytest.mark.parametrize("name", ("googlenet-ell-b64",
                                  "resnet50-tuned-serve"))
@pytest.mark.parametrize("fault", ("stale", "half_batch", "altered"))
def test_a_broken_timed_path_is_not_correct(name, fault):
    run = run_tiny(name, hook=lambda e: _Broken(e, fault))
    assert not run.correct, run.checks


@pytest.mark.parametrize("name", OFFLINE + SERVE)
def test_the_tf32_control_fails_the_limit(name):
    """The control: the reference itself in the program's place in the
    timed path, its convs and FC in TF32 (on the CPU every operand rounded
    to TF32); the run's own comparison has to find it not correct."""
    cell = tiny_cell(name)
    config = harness.config_file(cell["config"])
    hook = judge.tf32_control(cell, config, SEED, torch.device("cpu"))
    run = run_tiny(name, hook=hook)
    assert not run.correct, run.checks
    assert run.checks["logit_err"][0] > 3 * cell["limits"]["logit_err"]


def test_image_errors_are_relative_to_each_image():
    r = np.array([[1.0, -4.0], [100.0, 0.0]])
    y = r + np.array([[0.0, 0.004], [0.1, 0.0]])
    np.testing.assert_allclose(judge.image_errors(y, r), [0.001, 0.001])
    assert judge.image_errors(np.full_like(r, np.nan), r).max() == np.inf
