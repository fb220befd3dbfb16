"""The port's AdamW and learning-rate schedule against the JAX package's.

The same numpy params and gradients (a nested tree of dicts and lists) go
through the reference's ``adamw_update`` / ``clip_by_global_norm`` /
``cosine_schedule`` and the port's, step after step.  Both compute in f32,
but ``b1 ** step`` and ``b2 ** step`` are f32 powers that two libraries may
round one unit apart, and the global norm sums its leaves in another order
(JAX walks dict keys sorted, the port in insertion order).  So f32 results
are held to rtol = 1e-6, atol = 1e-7; bf16 params and moments, rounded once
from those f32 values, to one bf16 unit in the last place (2^-7 of the
larger side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro_torch.models.transformer import _tensor  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_schedule)
from repro_torch.optim import adamw as adamw_mod  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402

F32_TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"w": (8, 16), "b": (16,), "layers": [{"x": (4, 4)}, {"x": (4, 4)}]}


def _tree(rng, scale=1.0):
    return tree_map(lambda shape: (rng.standard_normal(shape) * scale)
                    .astype(np.float32), SHAPES)


def _jax(tree, dtype):
    return tree_map(lambda a: jnp.asarray(a, dtype=dtype), tree)


def _torch(tree, dtype):
    return tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _assert_same(got, want, dtype):
    want = dict(tree_paths(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), want)))
    for path, g in tree_paths(got):
        g = g.float().numpy()
        w = want[path]
        if dtype == torch.bfloat16:
            ulp = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
            assert bool((np.abs(g - w) <= ulp).all()), path
        else:
            np.testing.assert_allclose(g, w, err_msg=path, **F32_TOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_reference(state_dtype, grad_clip):
    """Three steps from the same params; gradients large enough that a clip
    of 1.0 scales them."""
    dtype = getattr(torch, state_dtype)
    jdtype = jnp.dtype(state_dtype)
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-2, grad_clip=grad_clip,
                                    state_dtype=state_dtype)
    cfg = AdamWConfig(lr=1e-2, grad_clip=grad_clip, state_dtype=state_dtype)
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    ref_p, p = _jax(p0, jdtype), _torch(p0, dtype)
    ref_opt, opt = ref_adamw.adamw_init(ref_p, ref_cfg), adamw_init(p, cfg)
    assert all(m.dtype == dtype for _, m in tree_paths(opt["m"]))
    for step in range(3):
        g = _tree(rng, scale=3.0)
        lr = 1e-2 * (step + 1) / 3
        ref_p, ref_opt, ref_norm = ref_adamw.adamw_update(
            ref_p, _jax(g, jdtype), ref_opt, ref_cfg, jnp.float32(lr))
        p, opt, norm = adamw_update(p, _torch(g, dtype), opt, cfg,
                                    torch.tensor(lr, dtype=torch.float32))
        assert int(opt["step"]) == int(ref_opt["step"]) == step + 1
        if grad_clip:
            assert float(norm) > grad_clip
        np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
        _assert_same(p, ref_p, dtype)
        _assert_same(opt["m"], ref_opt["m"], dtype)
        _assert_same(opt["v"], ref_opt["v"], dtype)
        assert all(x.dtype == dtype for _, x in tree_paths(p))
        assert all(x.dtype == dtype for _, x in tree_paths(opt["v"]))


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    g = _tree(np.random.default_rng(3), scale=2.0)
    want, want_norm = ref_adamw.clip_by_global_norm(
        _jax(g, jnp.dtype(dtype)), max_norm)
    got, norm = clip_by_global_norm(_torch(g, getattr(torch, dtype)),
                                    max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    _assert_same(got, want, getattr(torch, dtype))


def test_cosine_schedule_matches_reference():
    for warmup, total in ((10, 100), (1, 6), (2000, 20000)):
        for step in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                            total - 1, total, total + 5}):
            want = ref_schedule.cosine_schedule(
                jnp.int32(step), peak=3e-4, warmup=warmup, total=total)
            got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                  peak=3e-4, warmup=warmup, total=total)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-12, err_msg=str(step))
            # a Python int step gives the same
            assert float(cosine_schedule(step, peak=3e-4, warmup=warmup,
                                         total=total)) == float(got)


def test_adamw_optimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    opt = adamw_init(params, cfg)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, g, opt, cfg, 0.05)
    assert float(params["w"].abs().max()) < 1e-2


def test_updated_trees_are_freed_without_the_cycle_collector():
    """A state that no name holds any more is freed at once: the update is
    written into the given trees, and nothing it builds holds them in a
    reference cycle, so a train step's state does not wait for Python's
    cyclic collector (on the card, a whole copy of params and moments)."""
    import gc
    import weakref

    cfg = AdamWConfig()
    params = _torch(_tree(np.random.default_rng(0)), torch.float32)
    opt = adamw_init(params, cfg)
    grads = _torch(_tree(np.random.default_rng(1)), torch.float32)
    gc.disable()
    try:
        new_p, new_opt, _ = adamw_update(params, grads, opt, cfg, 1e-3)
        assert new_p is params and new_opt["m"] is opt["m"]
        watch = [weakref.ref(x) for _, x in tree_paths(new_p)
                 + tree_paths(new_opt["m"])]
        del new_p, new_opt, params, opt
        assert all(w() is None for w in watch)
    finally:
        gc.enable()


def test_bf16_numpy_leaves_cross_as_their_bits():
    """The tests' bridge (``transformer._tensor``) carries a bf16 array over
    bit for bit, as state_from_reference does with bf16 moments."""
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 11), dtype=jnp.bfloat16))
    t = _tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_update_is_written_in_place_slice_by_slice(monkeypatch, state_dtype,
                                                   grad_clip):
    """``adamw_update`` writes into the given params and moments, leaves
    the gradients as they were, and cutting each leaf into slices of at
    most 5 elements (whole rows; a longer row alone; a 0-d leaf as one)
    changes no bit against one slice a leaf, three steps running."""
    dtype = getattr(torch, state_dtype)
    cfg = AdamWConfig(lr=1e-2, grad_clip=grad_clip, state_dtype=state_dtype)
    rng = np.random.default_rng(11)

    def draw(scale):
        return {**_tree(rng, scale), "s": np.asarray(scale, np.float32)}

    p0 = draw(1.0)
    p, q = _torch(p0, dtype), _torch(p0, dtype)
    opt, opt_q = adamw_init(p, cfg), adamw_init(q, cfg)
    for step in range(3):
        g = draw(3.0)
        lr = torch.tensor(1e-2 * (step + 1) / 3, dtype=torch.float32)
        monkeypatch.setattr(adamw_mod, "UPDATE_SLICE", 1 << 24)
        p, opt, norm = adamw_update(p, _torch(g, dtype), opt, cfg, lr)
        given = [x for t in (q, opt_q["m"], opt_q["v"])
                 for _, x in tree_paths(t)]
        gq = _torch(g, dtype)
        monkeypatch.setattr(adamw_mod, "UPDATE_SLICE", 5)
        q, opt_q, norm_q = adamw_update(q, gq, opt_q, cfg, lr)
        assert [x for t in (q, opt_q["m"], opt_q["v"])
                for _, x in tree_paths(t)] == given  # the same tensors
        assert torch.equal(norm, norm_q)
        assert int(opt_q["step"]) == int(opt["step"]) == step + 1
        for a, b in ((p, q), (opt["m"], opt_q["m"]), (opt["v"], opt_q["v"]),
                     (_torch(g, dtype), gq)):
            for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
                assert torch.equal(x, y), path
