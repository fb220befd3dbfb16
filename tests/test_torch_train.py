"""The port's training path against the JAX package's.

The reference's ``init_state`` goes into the port through
``state_from_reference``; then both packages take 3 ``make_train_step``
steps on the same ``SyntheticLMDataset`` batches (B 4, T 32, a multiple of
the reference's attention chunk), under ``chunked`` and ``flash`` attention
(the reference's Pallas kernels in interpret mode, the port's plain
versions through its autograd Function), on ``TINY_LM`` of
``tests/test_system.py`` and the ``yi-9b`` smoke config, both in f32.
After every step the loss, grad norm, learning rate and step, and every
parameter and AdamW moment, are held to 1e-4 of max(1, max |x|) of the
reference's (f32 throughout; sums run in other orders).  The same with 2
microbatches, and ``loss_fn`` alone.

Port-only: the port's own ``test_training_reduces_loss_on_learnable_data``,
and ``launch.train`` on the CPU with a checkpoint directory, resumed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import flags as ref_flags  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import flags  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

TOL = 1e-4          # x max(1, max |reference|), per leaf and per metric
B, SEQ, STEPS = 4, 32, 3
TINY = dict(name="sys-lm", family="dense", n_layers=2, d_model=128,
            vocab=256, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
            dtype="float32")
OPT = dict(lr=3e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["chunked", "flash"])
def attn_impl(request):
    ref_flags.set_attn_impl(request.param)
    flags.set_attn_impl(request.param)
    yield request.param
    ref_flags.set_attn_impl("chunked")
    flags.set_attn_impl("chunked")


def _cfgs(arch):
    if arch == "tiny":
        return RefModelConfig(**TINY), ModelConfig(**TINY)
    return (dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(configs.get_config(arch, smoke=True),
                                dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    limit = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: max |port - reference| {err} > {limit}"


def _assert_state(state, ref_state, cfg, what):
    """Every param and moment of the port's state against the reference's,
    unstacked into the port's layout."""
    want = steps.state_from_reference(_np(ref_state), cfg, "cpu")
    assert int(state["opt"]["step"]) == int(want["opt"]["step"])
    for part in ("params", "m", "v"):
        g = state["params"] if part == "params" else state["opt"][part]
        w = dict(tree_paths(want["params"] if part == "params"
                            else want["opt"][part]))
        for path, leaf in tree_paths(g):
            _close(leaf.numpy(), w[path].numpy(), f"{what} {part}/{path}")


def _train_both(arch, microbatches):
    ref_cfg, cfg = _cfgs(arch)
    ref_state = ref_steps.init_state(ref_cfg, RefAdamWConfig(**OPT),
                                     jax.random.PRNGKey(0))
    state = steps.state_from_reference(_np(ref_state), cfg, "cpu")
    ref_step = jax.jit(ref_steps.make_train_step(
        ref_cfg, RefAdamWConfig(**OPT), num_microbatches=microbatches,
        total_steps=10))
    step = steps.make_train_step(cfg, AdamWConfig(**OPT),
                                 num_microbatches=microbatches,
                                 total_steps=10)
    ds = SyntheticLMDataset(DataConfig(seq_len=SEQ, global_batch=B,
                                       vocab=cfg.vocab, seed=0))
    losses = []
    for i in range(STEPS):
        batch = ds.batch_for(i)
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, m = step(state, batch)
        for key in ("loss", "grad_norm", "lr"):
            _close(float(m[key]), float(rm[key]), f"step {i} {key}")
        assert int(m["step"]) == int(rm["step"]) == i + 1
        _assert_state(state, ref_state, cfg, f"step {i}")
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ["tiny", "yi-9b"])
def test_train_steps_match_reference(arch, attn_impl):
    _train_both(arch, microbatches=1)


def test_microbatched_train_steps_match_reference(attn_impl):
    _train_both("tiny", microbatches=2)


@pytest.mark.parametrize("arch", ["tiny", "yi-9b"])
def test_loss_fn_matches_reference(arch, attn_impl):
    ref_cfg, cfg = _cfgs(arch)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(1))
    params = T.params_from_reference(_np(ref_params), cfg, "cpu")
    batch = SyntheticLMDataset(DataConfig(seq_len=SEQ, global_batch=2,
                                          vocab=cfg.vocab, seed=4)).batch_for(0)
    want = RT.loss_fn(ref_params, jnp.asarray(batch["tokens"]),
                      jnp.asarray(batch["labels"]), ref_cfg)
    toks = torch.from_numpy(batch["tokens"])
    labels = torch.from_numpy(batch["labels"])
    got = T.loss_fn(params, toks, labels, cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(float(got), float(want), "loss")
    # the embeds= entry gives the same loss from the same embeddings
    via_embeds = T.loss_fn(params, None, labels, cfg,
                           embeds=T.embed(params, toks, cfg))
    assert float(via_embeds) == float(got)


def test_state_from_reference_keeps_bf16_moments():
    ref_cfg, cfg = _cfgs("tiny")
    ref_state = ref_steps.init_state(
        ref_cfg, RefAdamWConfig(state_dtype="bfloat16"), jax.random.PRNGKey(2))
    state = steps.state_from_reference(_np(ref_state), cfg, "cpu")
    assert all(x.dtype == torch.float32 for _, x in
               tree_paths(state["params"]))
    for part in ("m", "v"):
        assert all(x.dtype == torch.bfloat16 for _, x in
                   tree_paths(state["opt"][part]))
    assert state["opt"]["step"].dtype == torch.int32


def test_unported_options_raise():
    _, cfg = _cfgs("tiny")
    with pytest.raises(NotImplementedError, match="multi-chip slice"):
        steps.make_train_step(cfg, AdamWConfig(), compress_cross_pod=True)
    mtp = dataclasses.replace(cfg, mtp_depth=1)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="later slice"):
        T.loss_fn(params, toks, toks, mtp)
    with pytest.raises(NotImplementedError, match="later slice"):
        train.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                    "--remat", "full"])


def test_training_reduces_loss_on_learnable_data():
    """Deterministic repeating pattern: CE must approach 0-ish quickly (the
    reference's test, on the port alone)."""
    cfg = ModelConfig(**TINY)
    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
    state = steps.init_state(cfg, opt_cfg, torch.Generator().manual_seed(0),
                             "cpu")
    step = steps.make_train_step(cfg, opt_cfg, total_steps=60)
    toks = torch.arange(32, dtype=torch.int32).repeat(4, 4)  # period-32 text
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(60):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--attn-impl", "flash"]
    try:
        train.main(args + ["--steps", "4"])
        first = capsys.readouterr().out
        assert "trained 4 steps" in first
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "step_000002", "step_000004"]
        train.main(args + ["--steps", "2"])
        second = capsys.readouterr().out
    finally:
        flags.set_attn_impl("chunked")
    assert "resumed from step 4" in second
    assert "trained 2 steps" in second
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000004", "step_000006"]
