"""The port's data pipeline, checkpoint store and restart loop against the
JAX package's.

* ``SyntheticLMDataset`` batches equal the reference's bit for bit for
  several (seed, step, host_id), with and without embeddings; the loader
  resumes mid-stream as the reference's does.
* Checkpoints: a round trip keeps every leaf bit for bit (bf16, f32, int32,
  nested lists); the on-disk layout is the reference's, so a step written
  by one package restores in the other; a step the reference wrote from
  one of several hosts (each host file holds every leaf) restores from the
  files there are; a step without COMMIT is ignored; async save and keep-k
  GC.
* ``StepRunner`` restores the last committed step after a retryable
  failure and ends bit-identical to an uninterrupted run, on the fixture of
  ``tests/test_data_checkpoint_runtime.py``; ``FailureDetector``
  classifies and counts strikes as the reference's does.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import data as ref_data  # noqa: E402
from repro.runtime import fault_tolerance as ref_ft  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_state, save_state)
from repro_torch.data import DataConfig, SyntheticLMDataset, make_loader  # noqa: E402
from repro_torch.runtime import (FailureDetector, StepRunner,  # noqa: E402
                                 StragglerMonitor)
from repro_torch.runtime.fault_tolerance import RETRYABLE_MARKERS  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402


# --------------------------- data pipeline ---------------------------------

@pytest.mark.parametrize("seed, step, n_hosts, host_id, embed_dim", [
    (0, 0, 1, 0, 0), (7, 5, 1, 0, 0), (1, 3, 2, 0, 0), (1, 3, 2, 1, 0),
    (3, 1000, 4, 2, 0), (2, 4, 1, 0, 8)])
def test_batches_equal_the_reference(seed, step, n_hosts, host_id, embed_dim):
    kw = dict(seq_len=16, global_batch=8, vocab=100, seed=seed,
              n_hosts=n_hosts, host_id=host_id, embed_dim=embed_dim)
    got = SyntheticLMDataset(DataConfig(**kw)).batch_for(step)
    want = ref_data.SyntheticLMDataset(ref_data.DataConfig(**kw)).batch_for(
        step)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_loader_resumes_mid_stream_as_the_reference():
    kw = dict(seq_len=8, global_batch=2, vocab=50, seed=3)
    loaders = [make_loader(DataConfig(**kw), start_step=2),
               ref_data.make_loader(ref_data.DataConfig(**kw), start_step=2)]
    try:
        for _ in range(3):
            got, want = (next(loader) for loader in loaders)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert loaders[0].step == 5
    finally:
        for loader in loaders:
            loader.close()
    ds = SyntheticLMDataset(DataConfig(**kw))
    fresh = make_loader(DataConfig(**kw), start_step=0)
    seq = [next(fresh)["tokens"] for _ in range(4)]
    fresh.close()
    np.testing.assert_array_equal(seq[3], ds.batch_for(3)["tokens"])


# --------------------------- checkpointing ---------------------------------

def _state():
    return {"params": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                       "b": torch.ones((3,), dtype=torch.float32),
                       "layers": [{"x": torch.full((2,), 0.1)},
                                  {"x": torch.full((2,), -3.5e-3,
                                                   dtype=torch.bfloat16)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _ref_state():
    return {"params": {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
                       "b": jnp.ones((3,), jnp.float32),
                       "layers": [{"x": jnp.full((2,), 0.1, jnp.float32)},
                                  {"x": jnp.full((2,), -3.5e-3,
                                                 jnp.bfloat16)}]},
            "opt": {"step": jnp.int32(7)}}


def _assert_equal_trees(got, want):
    want = dict(tree_paths(want))
    assert [p for p, _ in tree_paths(got)] == list(want)
    for path, g in tree_paths(got):
        assert g.dtype == want[path].dtype, path
        assert torch.equal(g, want[path]), path


def test_checkpoint_roundtrip(tmp_path):
    st = _state()
    save_state(st, str(tmp_path), 7)
    assert latest_step(str(tmp_path)) == 7
    assert sorted(p.name for p in (tmp_path / "step_000007").iterdir()) == [
        "COMMIT", "MANIFEST.json", "host_000.npz"]
    _assert_equal_trees(restore_state(_state(), str(tmp_path), 7), st)


def test_checkpoint_layout_is_the_reference_s(tmp_path):
    """A step the port writes restores in the reference, and one the
    reference writes restores in the port, bit for bit (bf16 as uint16)."""
    save_state(_state(), str(tmp_path / "port"), 3)
    back = ref_ckpt.restore_state(jax.eval_shape(_ref_state),
                                  str(tmp_path / "port"), 3)
    want = dict(tree_paths(_ref_state()))
    assert sorted(p for p, _ in tree_paths(back)) == sorted(want)
    for path, got in tree_paths(back):
        assert got.dtype == want[path].dtype, path
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want[path], np.float32))
    ref_ckpt.save_state(_ref_state(), str(tmp_path / "ref"), 4)
    _assert_equal_trees(restore_state(_state(), str(tmp_path / "ref"), 4),
                        _state())


def test_sharded_checkpoint_is_refused(tmp_path):
    """A step the reference wrote from one of two hosts: its manifest says
    2 hosts and its one file holds every leaf whole (the reference writes
    global leaves), so the port restores it from the union of the files
    there are, bit for bit; a leaf no file holds is refused."""
    ref_ckpt.save_state(_ref_state(), str(tmp_path), 2, host_id=0, n_hosts=2)
    assert latest_step(str(tmp_path)) == 2
    _assert_equal_trees(restore_state(_state(), str(tmp_path), 2), _state())
    with np.load(tmp_path / "step_000002" / "host_000.npz") as z:
        np.savez(tmp_path / "step_000002" / "host_000.npz",
                 **{k: z[k] for k in z.files if k != "params/b"})
    with pytest.raises(FileNotFoundError, match="params/b"):
        restore_state(_state(), str(tmp_path), 2)


def test_uncommitted_checkpoint_ignored(tmp_path):
    save_state(_state(), str(tmp_path), 5)
    (pathlib.Path(tmp_path) / "step_000009").mkdir()  # no COMMIT
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "missing")) is None


def test_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state()
    for s in (10, 20, 30):
        mgr.save_async(st, s)
    mgr.wait()
    mgr._gc()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [20, 30]
    back, step = mgr.restore_latest(_state())
    assert step == 30
    _assert_equal_trees(back, st)
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(_state()) == (None, None)


def test_async_save_snapshots_at_the_call(tmp_path):
    """The state is copied at ``save_async``: a later in-place change of a
    leaf does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save_async(st, 1)
    st["params"]["b"].add_(1.0)
    mgr.wait()
    back, _ = mgr.restore_latest(_state())
    assert torch.equal(back["params"]["b"], torch.ones(3))


# --------------------------- fault tolerance --------------------------------

def test_failure_detector_matches_the_reference():
    assert RETRYABLE_MARKERS == ref_ft.RETRYABLE_MARKERS
    det, ref_det = FailureDetector(max_strikes=2), ref_ft.FailureDetector(
        max_strikes=2)
    for exc in (RuntimeError("collective timeout DEADLINE_EXCEEDED"),
                ValueError("shape mismatch"), RuntimeError("UNAVAILABLE"),
                RuntimeError("heartbeat lost"), RuntimeError("UNAVAILABLE")):
        assert det.classify(exc) == ref_det.classify(exc)
        assert det.record(exc) == ref_det.record(exc)
    assert det.strikes == ref_det.strikes


def _run_flaky(tmp_path, step_runner, ckpt_manager, make):
    """The reference test's fixture: a transient failure at the 6th call;
    returns (final, end, failed, uninterrupted final)."""
    calls = {"n": 0, "failed": False}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 6 and not calls["failed"]:
            calls["failed"] = True
            raise RuntimeError("transient collective UNAVAILABLE")
        s = state["s"] + int(batch["tokens"].sum()) % 97
        return {"s": s}, {"loss": float(s)}

    def clean_step(state, batch):
        return {"s": state["s"] + int(batch["tokens"].sum()) % 97}, {
            "loss": 0.0}

    dcfg_kw = dict(seq_len=4, global_batch=2, vocab=13, seed=0)
    runner = step_runner(flaky_step, ckpt_manager(str(tmp_path / "a"),
                                                  keep=3),
                         lambda s: make(dcfg_kw, s), ckpt_every=2)
    final, end = runner.run({"s": 0}, 0, 8)
    runner2 = step_runner(clean_step, ckpt_manager(str(tmp_path / "b"),
                                                   keep=3),
                          lambda s: make(dcfg_kw, s), ckpt_every=100)
    ref, _ = runner2.run({"s": 0}, 0, 8)
    return final, end, calls["failed"], ref


def test_step_runner_restart_after_failure(tmp_path):
    final, end, failed, clean = _run_flaky(
        tmp_path / "port", StepRunner, CheckpointManager,
        lambda kw, s: make_loader(DataConfig(**kw), s))
    assert end == 8 and failed
    assert int(final["s"]) == int(clean["s"])
    ref_final, _, _, _ = _run_flaky(
        tmp_path / "ref", ref_ft.StepRunner, ref_ckpt.CheckpointManager,
        lambda kw, s: ref_data.make_loader(ref_data.DataConfig(**kw), s))
    assert int(final["s"]) == int(ref_final["s"])


def test_step_runner_escalates_fatal_failures(tmp_path):
    def bad_step(state, batch):
        raise ValueError("shape mismatch")

    runner = StepRunner(bad_step, CheckpointManager(str(tmp_path)),
                        lambda s: make_loader(DataConfig(
                            seq_len=4, global_batch=2, vocab=13), s))
    with pytest.raises(ValueError, match="shape mismatch"):
        runner.run({"s": 0}, 0, 3)


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(warmup_steps=3)
    for _ in range(20):
        assert not mon.observe(1.0)
    assert mon.observe(5.0)


@pytest.mark.parametrize("host_times", [
    {0: 1.0, 1: 1.1, 2: 9.0, 3: 0.9},   # the reference test's case
    {}, {0: 3.0}, {0: 1.0, 1: 2.4, 2: 2.6, 3: 1.2},
    {0: 1.0, 1: 1.0, 2: 1.0, 3: 2.6, 4: 5.0}])
def test_straggler_monitor_host_lag(host_times):
    """The hosts lagging the median (over 1.5x it and by more than 1 s),
    as the reference's ``observe_hosts`` flags them."""
    lag = StragglerMonitor().observe_hosts(host_times)
    assert lag == ref_ft.StragglerMonitor().observe_hosts(host_times)
    if host_times == {0: 1.0, 1: 1.1, 2: 9.0, 3: 0.9}:
        assert lag == [2]
    if len(host_times) == 5:
        assert lag == [3, 4]
