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

At head dims 80 and 96 (``ENC80``, a bidirectional encoder, and
``VLM96``, a causal VLM backbone: 2 layers, 2 heads, d_model 2 d, f32, on
the data pipeline's embeddings) the same 3 steps under ``flash``.

Remat: under ``flags.REMAT`` ``dots`` and ``full`` the port takes the same
3 steps as the reference under its ``set_remat`` (1e-4, as above), and on
the CPU the three policies give bit-identical losses and gradients on a
dense, a MoE and an ssm smoke config; ``dots`` keeps the projections'
outputs (no ``aten.mm`` of the forward runs again in the backward, where
``full`` reruns them all).  MTP: on ``deepseek-v3-671b``'s f32 smoke
config ``params_from_reference`` carries ``mtp``, and ``loss_fn`` (with its
two-ahead term) and every gradient match the reference's within 1e-4.

Port-only: the port's own ``test_training_reduces_loss_on_learnable_data``,
and ``launch.train`` on the CPU with a checkpoint directory, resumed, with
``--remat full``, on DeepSeek-V3 (MTP) and on the bf16 encoder and VLM
smoke configs (f32 embeddings).
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
# the flash backward's head dims 80 and 96 at 2 layers, 2 heads
ENC80 = dict(name="enc80", family="encoder", n_layers=2, d_model=160,
             vocab=64, n_heads=2, n_kv_heads=2, head_dim=80, d_ff=320,
             mlp_act="gelu", causal=False, dtype="float32")
VLM96 = dict(name="vlm96", family="vlm", n_layers=2, d_model=192,
             vocab=256, n_heads=2, n_kv_heads=2, head_dim=96, d_ff=384,
             dtype="float32")
NARROW = {"tiny": TINY, "enc80": ENC80, "vlm96": VLM96}


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
    if arch in NARROW:
        return RefModelConfig(**NARROW[arch]), ModelConfig(**NARROW[arch])
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
    embed_dim = cfg.d_model if cfg.family in ("vlm", "encoder") else 0
    ds = SyntheticLMDataset(DataConfig(seq_len=SEQ, global_batch=B,
                                       vocab=cfg.vocab, seed=0,
                                       embed_dim=embed_dim))
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


@pytest.fixture
def flash():
    ref_flags.set_attn_impl("flash")
    flags.set_attn_impl("flash")
    yield
    ref_flags.set_attn_impl("chunked")
    flags.set_attn_impl("chunked")


@pytest.mark.parametrize("arch", ["enc80", "vlm96"])
def test_train_steps_at_head_dims_80_and_96_match_reference(arch, flash):
    _, cfg = _cfgs(arch)
    assert cfg.head_dim in (80, 96) and cfg.d_model == 2 * cfg.head_dim
    _train_both(arch, microbatches=1)


@pytest.fixture(params=["dots", "full"])
def remat(request):
    ref_flags.set_remat(request.param)
    flags.set_remat(request.param)
    yield request.param
    ref_flags.set_remat("none")
    flags.set_remat("none")


def test_remat_train_steps_match_reference(remat):
    _train_both("yi-9b", microbatches=1)


def _grads_under(policy, cfg, params, batch):
    flags.set_remat(policy)
    try:
        return steps.loss_and_grads(cfg, params, batch)
    finally:
        flags.set_remat("none")


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b", "mamba2-2.7b"])
def test_remat_policies_are_bit_identical(arch):
    """The recomputed forward is the same arithmetic: the loss and every
    gradient are the same bits under none, dots and full."""
    _, cfg = _cfgs(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        DataConfig(seq_len=SEQ, global_batch=2, vocab=cfg.vocab,
                   seed=1)).batch_for(0).items()}
    loss0, g0 = _grads_under("none", cfg, params, batch)
    for policy in ("dots", "full"):
        loss, g = _grads_under(policy, cfg, params, batch)
        assert torch.equal(loss, loss0), policy
        assert len(g) == len(g0)
        for a, b in zip(g, g0):
            assert torch.equal(a, b), policy


def test_dots_keeps_the_projections_and_full_recomputes_them():
    """Under ``dots`` the backward reruns no forward ``aten.mm`` (the
    projections' outputs are kept), under ``full`` it reruns every one,
    and under ``none`` nothing is rerun: counted by a dispatch mode around
    ``backward()``, against the mm launches of the backward proper."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    _, cfg = _cfgs("tiny")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 16), dtype=torch.int64)
    counts = {}
    for policy in ("none", "dots", "full"):
        flags.set_remat(policy)
        try:
            leaves = [p.requires_grad_() for _, p in tree_paths(params)]
            fwd = CountMM()
            with fwd:
                loss = T.loss_fn(params, toks, toks, cfg)
            bwd = CountMM()
            with bwd:
                loss.backward()
            counts[policy] = (fwd.n, bwd.n)
        finally:
            flags.set_remat("none")
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
    # a layer's projections are 7 mm's (wq, wk, wv, wo, gate, up, down;
    # the head is outside the stack); ``full`` reruns each but the block's
    # last (down), whose output no backward needs: the recompute stops
    # once it has every saved tensor
    assert cfg.mlp_act == "swiglu"
    assert counts["none"][0] == counts["dots"][0] == counts["full"][0]
    assert counts["dots"][1] == counts["none"][1]
    assert counts["full"][1] == counts["none"][1] + cfg.n_layers * (7 - 1)


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
    """``compress_cross_pod`` is ported (the int8 all-reduce over a mesh's
    "pod" dim, ``tests/test_torch_distributed.py``); without a pod dim it
    is a no-op, as in the reference: on one device the step equals the
    uncompressed one bit for bit."""
    _, cfg = _cfgs("tiny")
    b = SyntheticLMDataset(DataConfig(seq_len=SEQ, global_batch=B,
                                      vocab=cfg.vocab, seed=2)).batch_for(0)
    got = []
    for compress in (False, True):
        state = steps.init_state(cfg, AdamWConfig(**OPT),
                                 torch.Generator().manual_seed(0), "cpu")
        step = steps.make_train_step(cfg, AdamWConfig(**OPT),
                                     compress_cross_pod=compress,
                                     total_steps=10)
        for _ in range(2):
            state, m = step(state, b)
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    state["params"]["embed"].clone()))
    assert got[0][:2] == got[1][:2]
    assert torch.equal(got[0][2], got[1][2])


@pytest.fixture(scope="module")
def mtp_model():
    ref_cfg, cfg = _cfgs("deepseek-v3-671b")
    assert cfg.mtp_depth == 1
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(3))
    return ref_cfg, cfg, ref_params, T.params_from_reference(
        _np(ref_params), cfg, "cpu")


def test_mtp_params_carry_over(mtp_model):
    """``params_from_reference`` carries the reference's ``mtp`` head
    leaf for leaf, and the port's ``init_params`` draws the same tree."""
    _, cfg, ref_params, params = mtp_model
    assert sorted(params["mtp"]) == sorted(ref_params["mtp"]) == [
        "block", "norm", "proj"]
    want = dict(jax.tree_util.tree_flatten_with_path(ref_params["mtp"])[0])
    for (path, leaf), (rpath, rleaf) in zip(
            tree_paths(params["mtp"]),
            jax.tree_util.tree_flatten_with_path(ref_params["mtp"])[0]):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(rleaf))
    assert len(want) == len(tree_paths(params["mtp"]))
    own = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    drawn = dict(tree_paths(own))
    for path, leaf in tree_paths(params):
        assert drawn[path].shape == leaf.shape, path
        assert drawn[path].dtype == leaf.dtype, path
    assert len(drawn) == len(tree_paths(params))


def test_mtp_loss_and_grads_match_reference(mtp_model):
    ref_cfg, cfg, ref_params, params = mtp_model
    batch = SyntheticLMDataset(DataConfig(seq_len=SEQ, global_batch=2,
                                          vocab=cfg.vocab,
                                          seed=5)).batch_for(0)
    toks, labels = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    want, ref_grads = jax.value_and_grad(
        lambda p: RT.loss_fn(p, toks, labels, ref_cfg))(ref_params)
    got, grads = steps.loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(float(got), float(want), "loss")
    # the term is there: the embeds entry (no MTP) gives a smaller loss
    base = T.loss_fn(params, None, torch.from_numpy(batch["labels"]), cfg,
                     embeds=T.embed(params, torch.from_numpy(batch["tokens"]),
                                    cfg))
    assert float(got) > float(base)
    want_grads = dict(tree_paths(T.params_from_reference(
        _np(ref_grads), cfg, "cpu")))
    paths = [path for path, _ in tree_paths(params)]
    assert any(path.startswith("mtp/") for path in paths)
    for path, g in zip(paths, grads):
        _close(g.numpy(), want_grads[path].numpy(), f"grad {path}")


def test_train_cli_trains_with_the_mtp_term(capsys):
    train.main(["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
                "--steps", "2", "--batch", "2", "--seq", "16"])
    assert "trained 2 steps" in capsys.readouterr().out


def test_train_cli_with_remat_full(capsys):
    try:
        train.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--remat", "full", "--attn-impl", "flash"])
    finally:
        flags.set_remat("none")
        flags.set_attn_impl("chunked")
    assert "trained 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["hubert-xlarge", "phi-3-vision-4.2b"])
def test_train_cli_trains_bf16_model_on_f32_embeds(arch, capsys):
    """The bf16 smoke configs on the data pipeline's f32 embeddings (the
    repaired fault: the port raised on mixed dtypes)."""
    try:
        train.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "32",
                    "--attn-impl", "flash"])
    finally:
        flags.set_attn_impl("chunked")
    assert "trained 2 steps" in capsys.readouterr().out


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
