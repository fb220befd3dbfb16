"""The port's serving stack: ``ServeEngine`` against the JAX package's, the
reference's batcher and engine tests against the port's scheduler, and the
entry points.

The engine comparison serves the same requests through both packages on the
f32 ``yi-9b`` smoke config at sparsity 0.8 (the reference's sparse params,
carried over): each request's output tokens must be identical.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import serving as ref_serving  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs, telemetry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import (ContinuousBatcher,  # noqa: E402
                                 DrainExhaustedWarning, Request, ServeEngine,
                                 StragglerTickWarning)

CFG = ModelConfig(name="srv", family="dense", n_layers=2, d_model=64,
                  vocab=128, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                  dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine(n_slots=4, max_len=64):
    params = T.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    cache = T.init_cache(CFG, n_slots, max_len, "cpu")
    return ServeEngine(make_serve_step(CFG), params, cache, n_slots, max_len,
                       device="cpu")


# -- the port's engine against the reference's ----------------------------

def _requests(cls, seed=3, n=7, vocab=512):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, int(rng.integers(2, 7))).tolist(),
                max_new_tokens=int(rng.integers(3, 9))) for i in range(n)]


def test_serve_engine_matches_reference_tokens():
    ref_cfg = dataclasses.replace(ref_configs.get_config("yi-9b", smoke=True),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_config("yi-9b", smoke=True),
                              dtype="float32")
    ref_params = ref_serve.sparsify_params(
        RT.init_params(ref_cfg, jax.random.PRNGKey(0)), ref_cfg, 0.8)
    n_slots, max_len = 3, 24
    ref_eng = ref_serving.ServeEngine(
        jax.jit(ref_steps.make_serve_step(ref_cfg)), ref_params,
        RT.init_cache(ref_cfg, n_slots, max_len), n_slots, max_len)
    eng = ServeEngine(
        make_serve_step(cfg),
        T.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                "cpu"),
        T.init_cache(cfg, n_slots, max_len, "cpu"), n_slots, max_len,
        device="cpu")
    ref_reqs = _requests(ref_serving.Request)
    reqs = _requests(Request)
    for r in ref_reqs:
        ref_eng.submit(r)
    for r in reqs:
        eng.submit(r)
    ref_done = ref_eng.run_until_drained()
    done = eng.run_until_drained()
    assert done.drained and ref_done.drained and done.ticks == ref_done.ticks
    for a, b in zip(ref_reqs, reqs):
        assert b.done and len(b.output) == b.max_new_tokens
        assert b.output == a.output, b.rid


# -- the reference's batcher / engine tests, on the port's scheduler ------

def test_batcher_admit_retire():
    b = ContinuousBatcher(2, 32)
    r1, r2, r3 = (Request(i, [1, 2], max_new_tokens=1) for i in range(3))
    for r in (r1, r2, r3):
        b.submit(r)
    assert b.admit() == 2 and b.active == 2
    assert b.queue == [r3]
    b.slots[0].request.output.append(7)  # hit budget
    retired = b.retire()
    assert retired == [r1] and r1.done
    assert b.admit() == 1 and b.active == 2


def test_batcher_rejects_oversize():
    b = ContinuousBatcher(1, 8)
    r = Request(0, list(range(6)), max_new_tokens=8)
    b.submit(r)
    b.admit()
    assert r.done and b.active == 0
    assert b.rejected == [r]


def test_run_until_drained_mixes_rejected_and_served():
    eng = _engine(n_slots=2, max_len=12)
    ok = Request(0, [1, 2, 3], max_new_tokens=4)
    oversize = Request(1, list(range(10)), max_new_tokens=8)
    eng.submit(ok)
    eng.submit(oversize)
    done = eng.run_until_drained()
    assert ok in done and len(ok.output) == 4
    assert oversize in done and oversize.done and oversize.output == []
    assert len(done) == 2


def test_staggered_admission_generates_full_budget():
    eng = _engine(n_slots=2, max_len=14)
    r1 = Request(0, [1, 2, 3], max_new_tokens=8)
    eng.submit(r1)
    for _ in range(4):
        eng.tick()
    r2 = Request(1, [4, 5, 6], max_new_tokens=8)
    eng.submit(r2)
    eng.run_until_drained()
    assert r1.done and len(r1.output) == 8
    assert r2.done and len(r2.output) == 8


def test_midstream_admission_when_capacity_allows():
    eng = _engine(n_slots=2, max_len=32)
    r1 = Request(0, [1, 2, 3], max_new_tokens=10)
    eng.submit(r1)
    for _ in range(4):
        eng.tick()
    r2 = Request(1, [4, 5], max_new_tokens=4)
    eng.submit(r2)
    eng.tick()
    assert eng.batcher.active == 2
    eng.run_until_drained()
    assert len(r1.output) == 10 and len(r2.output) == 4


def test_engine_deterministic_per_request():
    eng1 = _engine(n_slots=1, max_len=48)
    r_solo = Request(0, [5, 6, 7], max_new_tokens=4)
    eng1.submit(r_solo)
    eng1.run_until_drained()
    eng2 = _engine(n_slots=2, max_len=48)
    r_a = Request(1, [5, 6, 7], max_new_tokens=4)
    r_b = Request(2, [9, 9, 9], max_new_tokens=4)
    eng2.submit(r_a)
    eng2.submit(r_b)
    eng2.run_until_drained()
    assert r_a.output == r_solo.output


def test_serving_telemetry_metrics():
    telemetry.reset()
    eng_off = _engine(n_slots=2, max_len=16)
    eng_off.submit(Request(0, [1, 2], max_new_tokens=2))
    eng_off.run_until_drained()
    assert telemetry.snapshot() == {}
    with telemetry.enabled():
        eng = _engine(n_slots=2, max_len=16)
        for i in range(4):
            eng.submit(Request(i, [1 + i, 2], max_new_tokens=3))
        eng.submit(Request(9, list(range(12)), max_new_tokens=8))
        eng.run_until_drained()
        snap = telemetry.snapshot()
        assert snap["serving.admissions"]["value"] == 4
        assert snap["serving.rejections"]["value"] == 1
        assert snap["serving.retirements"]["value"] == 4
        assert snap["serving.active_slots"]["value"] == 0
        hist = telemetry.histogram("serving.tick_latency_s")
        assert 0 < hist.min <= hist.p50 <= hist.p99 <= hist.max
    telemetry.reset()


def test_straggler_tick_flagged_counted_and_warned_once():
    state = {"n": 0}

    def slow_step(p, t, c, l):
        state["n"] += 1
        if state["n"] in (10, 12):
            time.sleep(0.05)
        return t[:, 0] + 1, c

    eng = ServeEngine(slow_step, params=None, cache=None, n_slots=2,
                      max_len=64, device="cpu")
    eng.submit(Request(0, [1, 2, 3], max_new_tokens=16))
    telemetry.reset()
    with telemetry.enabled():
        with pytest.warns(StragglerTickWarning) as caught:
            eng.run_until_drained()
        snap = telemetry.snapshot()
    telemetry.reset()
    assert len(caught) == 1
    assert snap["serving.straggler_ticks"]["value"] >= 1
    assert eng.monitor.flags


def test_run_until_drained_reports_exhaustion():
    eng = _engine(n_slots=1, max_len=64)
    reqs = [Request(i, [1, 2, 3], max_new_tokens=8) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    with pytest.warns(DrainExhaustedWarning):
        out = eng.run_until_drained(max_ticks=2)
    assert out.drained is False and out.ticks == 2 and out.pending > 0
    done = eng.run_until_drained()
    assert done.drained is True and all(r.done for r in reqs)


def test_decode_writes_every_slot_at_the_shared_cursor():
    """All slots' K and V land at ``cur_len``, in place; nothing else moves."""
    eng = _engine(n_slots=3, max_len=16)
    before = [c["k"].clone() for c in eng.cache["layers"]]
    nxt, cache = eng.step(eng.params, torch.tensor([[1], [2], [3]]),
                          eng.cache, 5)
    assert cache is eng.cache and nxt.shape == (3,)
    for old, c in zip(before, cache["layers"]):
        changed = (c["k"] != old).any(dim=3).any(dim=2)   # (slots, positions)
        assert changed[:, 5].all() and not changed[:, :5].any()
        assert not changed[:, 6:].any()


# -- entry points -------------------------------------------------------------

def test_params_from_reference_takes_bf16_leaves():
    ref_cfg = ref_configs.get_config("yi-9b", smoke=True)      # bf16
    cfg = configs.get_config("yi-9b", smoke=True)
    ref_params = ref_serve.sparsify_params(
        RT.init_params(ref_cfg, jax.random.PRNGKey(2)), ref_cfg, 0.8)
    np_params = jax.tree.map(np.asarray, ref_params)
    assert np_params["embed"].dtype.name == "bfloat16"
    params = T.params_from_reference(np_params, cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["embed"].float().numpy(),
        np.asarray(ref_params["embed"], np.float32))
    wq = params["layers"][1]["mixer"]["wq"]
    assert wq.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.blocks.float().numpy(),
        np.asarray(ref_params["stack"]["sub0"]["mixer"]["wq"].blocks[1]))
    toks = torch.randint(0, cfg.vocab, (2, 8))
    logits, _ = T.forward(params, toks, cfg)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("yi-9b", smoke=True)
    for call in (lambda: T.init_params(cfg, torch.Generator()),
                 lambda: T.init_cache(cfg, 1, 4),
                 lambda: ServeEngine(None, None, None, 1, 4),
                 lambda: serve.main(["--arch", "yi-9b", "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2",
                "--prompt-len", "4", "--gen", "3", "--sparsity", "0.8",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Escoin BCSR weights at sparsity 0.8" in out
    assert "generated 3 tokens x 2 seqs on cpu" in out


def test_registry_names_what_waits():
    """Nothing waits any more: the registry holds the reference's ten
    archs, in its order, each config field for field the reference's, and
    an unknown name raises as there."""
    assert configs.list_archs() == ref_configs.list_archs()
    assert len(configs.list_archs()) == 10
    for arch in configs.list_archs():
        for smoke in (False, True):
            assert dataclasses.asdict(configs.get_config(arch, smoke=smoke)) \
                == dataclasses.asdict(ref_configs.get_config(arch, smoke=smoke))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("olmoe-1b-7b-nonexistent")
