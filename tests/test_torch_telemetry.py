"""The port's telemetry against the JAX package's: the tracer's documents
pass both packages' ``validate_chrome_trace`` (a timed forward's, and the
autotune CLI's ``--trace`` on the CPU), the fallback warnings and counters
behave alike, and the ``engine.*``, ``tuning.plan.*`` and ``fallback.*``
counters match the reference's for the same calls on the same micro net.
"""
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import telemetry as ref_telemetry  # noqa: E402
from repro import tuning as ref_tuning  # noqa: E402
from repro.engine import CnnEngine as RefEngine  # noqa: E402
from repro.engine import lower as ref_lower  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.engine import (CnnEngine, lower,  # noqa: E402
                                params_from_reference, spec)
from repro_torch.launch import serve  # noqa: E402

VALIDATORS = (telemetry.validate_chrome_trace,
              ref_telemetry.validate_chrome_trace)


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, ref_telemetry):
        t.disable()
        t.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for t in (telemetry, ref_telemetry):
        t.disable()
        t.reset()


def _micro(mod):
    return [mod.Conv("c0", 8, 3, 1, 1, sparsity=0.0), mod.Relu(),
            mod.Conv("c1", 8, 3, 1, 1, sparsity=0.75), mod.Relu(),
            mod.Conv("c2", 16, 1, 1, 0, sparsity=0.6), mod.Relu(),
            mod.Pool("gap"), mod.FC("fc", 10)]


def _engines(image=8):
    """The reference's micro engine (its telemetry tests' net, one 1x1 conv
    more) and the port's on the same weights, each with its own roofline
    plan applied (the reference's backend name, ``cpu``, in both)."""
    rng = np.random.default_rng(0)
    ref_net = _micro(ref_cnn)
    ref_prog = ref_lower(ref_net, (3, image, image))
    ref_params = ref_cnn.init_cnn(ref_net, 3, rng, image)
    params = params_from_reference(
        {k: (v if k == "_fc_rng" else {"w": np.asarray(v["w"]),
                                       "b": np.asarray(v["b"])})
         for k, v in ref_params.items()}, device="cpu")
    prog = lower(_micro(spec), (3, image, image))
    ref_plan = ref_tuning.plan_program(ref_prog, batch=1, mode="roofline",
                                       cache=ref_tuning.PlanCache())
    plan = tuning.plan_program(prog, batch=1, mode="roofline",
                               cache=tuning.PlanCache(), backend="cpu")
    ref_tuning.apply_plan_to_params(ref_params, ref_plan)
    tuning.apply_plan_to_params(params, plan)
    x = rng.standard_normal((1, 3, image, image)).astype(np.float32)
    return (RefEngine(ref_prog, ref_params, ref_plan),
            CnnEngine(prog, params, plan, device="cpu"), x)


def _validate(doc):
    for validate in VALIDATORS:
        validate(doc)
    json.dumps(doc)


def test_tracer_documents_pass_both_validators(tmp_path):
    tracer = telemetry.Tracer()
    with tracer.span("outer", cat="test", foo=1):
        tracer.instant("marker", cat="test")
    tracer.complete("op", dur_s=1e-3, cat="op.roofline",
                    tid=telemetry.TID_ROOFLINE, args={"method": "pallas"})
    doc = tracer.to_chrome_trace()
    _validate(doc)
    ref_tracer = ref_telemetry.Tracer()
    ref_tracer.complete("op", dur_s=1e-3)
    ref_doc = ref_tracer.to_chrome_trace()
    assert doc["traceEvents"][:2] == ref_doc["traceEvents"][:2]   # lanes
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1,
                            "tid": 0, "dur": -5}]}
    for validate in VALIDATORS:
        with pytest.raises(ValueError):
            validate(bad)
    path = tracer.export(str(tmp_path / "t.json"))
    _validate(json.load(open(path)))


def test_forward_timed_trace_passes_both_validators(tmp_path):
    _, eng, x = _engines()
    y = eng.forward_timed(x, "auto")
    torch.testing.assert_close(y, eng(x, "auto"), rtol=1e-5, atol=1e-6)
    rep = eng.last_report
    assert rep.timed and all(o.wall_s is not None and o.wall_s >= 0
                             for o in rep.ops)
    doc = telemetry.get_tracer().to_chrome_trace()
    _validate(doc)
    wall = {ev["name"] for ev in doc["traceEvents"]
            if ev["ph"] == "X" and ev["tid"] == telemetry.TID_WALL}
    assert {o.name for o in rep.ops} <= wall
    rep.emit_spans(telemetry.get_tracer())
    _validate(json.load(open(telemetry.get_tracer().export(
        str(tmp_path / "trace.json")))))


def test_autotune_cli_trace_passes_both_validators(tmp_path, capsys):
    out = tmp_path / "trace.json"
    cache = tmp_path / "plans" / "cache.json"
    serve.main(["--autotune", "--cnn", "alexnet", "--smoke", "--device",
                "cpu", "--plan-cache", str(cache), "--trace", str(out)])
    text = capsys.readouterr().out
    assert "plan cache round-trip ok" in text
    assert "auto-vs-dense slice check ok" in text
    assert "fallbacks=0" in text
    doc = json.loads(out.read_text())
    _validate(doc)
    assert any(ev["ph"] == "X" and ev["tid"] == telemetry.TID_WALL
               for ev in doc["traceEvents"])
    assert any(ev["ph"] == "X" and ev["tid"] == telemetry.TID_ROOFLINE
               for ev in doc["traceEvents"])
    # the saved plan loads in the reference and serves the card's key only
    saved = json.loads(cache.read_text())
    assert saved["version"] == 6
    assert all(k.endswith("_cpu") for k in saved["entries"])
    assert len(ref_tuning.PlanCache(str(cache))) == len(saved["entries"])


def test_default_plan_cache_is_in_the_ignored_build_dir():
    assert "/build/plans/" in serve.DEFAULT_PLAN_CACHE.replace("\\", "/")


def test_engine_and_plan_counters_match_the_reference(tmp_path):
    """Plan cold into a file, plan again from it, then three forwards (two
    of one configuration) and a report: the same counters."""
    ref_eng, eng, x = _engines()
    paths = (str(tmp_path / "port.json"), str(tmp_path / "ref.json"))
    with telemetry.enabled(), ref_telemetry.enabled():
        for _ in range(2):
            tuning.plan_program(eng.program, cache=tuning.PlanCache(paths[0]),
                                backend="cpu")
            ref_tuning.plan_program(ref_eng.program,
                                    cache=ref_tuning.PlanCache(paths[1]))
        for method in ("auto", "auto", "dense"):
            eng(x, method)
            ref_eng(jnp.asarray(x), method)
        eng.execution_report(x.shape, "auto")
        ref_eng.execution_report(x.shape, "auto")
        snap = telemetry.snapshot()
        ref_snap = ref_telemetry.snapshot()
    keys = [k for k in ref_snap
            if k.startswith(("engine.", "tuning.", "fallback."))]
    assert {k: snap[k] for k in keys} == {k: ref_snap[k] for k in keys}
    assert snap["engine.forwards"]["value"] == 3
    assert snap["engine.jit_hits"]["value"] == 1
    assert snap["engine.jit_misses"]["value"] == 2
    assert snap["tuning.plan.cache_hit"]["value"] > 0


def test_fallback_warnings_and_counters_match_the_reference():
    for t in (telemetry, ref_telemetry):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(2):
                t.record_fallback("engine", "stale_plan_no_block",
                                  layer="conv2", geometry="m=4 c=4",
                                  fallback_to="dense")
        assert len(w) == 1 and "stale_plan_no_block" in str(w[0].message)
        assert "fallback.total" not in t.snapshot()
        with t.enabled(), warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            t.record_fallback("engine", "value_dtype_mismatch",
                              layer="conv3", fallback_to="dense")
        with pytest.raises(ValueError):
            t.record_fallback("engine", "not_a_reason")
    assert telemetry.snapshot() == ref_telemetry.snapshot()
    assert telemetry.REASONS == ref_telemetry.REASONS


def test_disabled_telemetry_records_nothing():
    _, eng, x = _engines()
    y_off = eng(x, "auto")
    assert eng.last_report is None
    assert telemetry.snapshot() == {} and len(telemetry.get_tracer()) == 0
    with telemetry.enabled():
        y_on = eng(x, "auto")
    torch.testing.assert_close(y_on, y_off, rtol=0, atol=0)
    assert eng.last_report is not None and eng.last_report.jit_cache_hit
