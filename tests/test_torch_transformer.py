"""The port's transformer against the JAX package's, on the f32 smoke
configs of ``yi-9b`` (GQA 2:1) and ``qwen1.5-0.5b`` (QKV bias).

The reference's params are drawn with ``jax.random`` and carried over with
``params_from_reference``; the same token ids go through both.  Held to
rtol = atol = 1e-4 (f32 throughout; sums run in other orders):

* ``forward`` logits under ``ATTN_IMPL`` ``chunked`` and ``flash`` (the
  reference's Pallas kernel in interpret mode, the port's plain version);
* 16 ``decode_step``s through the KV cache: the same argmax tokens and the
  same logits;
* both again with the weights at sparsity 0.8: the reference's
  ``sparsify_params`` carried over (stacked BCSR leaves), and the port's own
  ``sparsify_params`` on the carried dense weights;
* ``make_prefill_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import flags as ref_flags  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.sparse_format import BcsrMatrix  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import flags  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["yi-9b", "qwen1.5-0.5b"]
B, LEN = 2, 16


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
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype="float32")
    return ref_cfg, cfg


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    ref_cfg, cfg = _cfgs(request.param)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, LEN),
                                             dtype=np.int32)
    return ref_cfg, cfg, ref_params, toks


def _forward_both(ref_cfg, cfg, ref_params, params, toks):
    want, _ = RT.forward(ref_params, jnp.asarray(toks), ref_cfg)
    got, _ = T.forward(params, torch.from_numpy(toks), cfg)
    return np.asarray(want), got.numpy()


def _decode_both(ref_cfg, cfg, ref_params, params, toks):
    step = jax.jit(lambda p, t, c, l: RT.decode_step(p, ref_cfg, t, c, l))
    rc = RT.init_cache(ref_cfg, B, LEN)
    pc = T.init_cache(cfg, B, LEN, "cpu")
    want, got = [], []
    for i in range(LEN):
        lg, rc = step(ref_params, jnp.asarray(toks[:, i:i + 1]), rc,
                      jnp.int32(i))
        want.append(np.asarray(lg))
        lg, pc = T.decode_step(params, cfg, torch.from_numpy(toks[:, i:i + 1]),
                               pc, i)
        got.append(lg.numpy())
    return np.stack(want, 1), np.stack(got, 1)


def test_params_carry_over_per_layer(model):
    ref_cfg, cfg, ref_params, _ = model
    params = T.params_from_reference(_to_numpy(ref_params), cfg, "cpu")
    assert len(params["layers"]) == cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        want = np.asarray(ref_params["stack"]["sub0"]["mixer"]["wq"][i])
        np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(), want)
    assert ("bq" in params["layers"][0]["mixer"]) == cfg.qkv_bias


def test_forward_matches_reference(model, attn_impl):
    ref_cfg, cfg, ref_params, toks = model
    params = T.params_from_reference(_to_numpy(ref_params), cfg, "cpu")
    want, got = _forward_both(ref_cfg, cfg, ref_params, params, toks)
    assert got.shape == (B, LEN, cfg.vocab)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_steps_match_reference(model):
    ref_cfg, cfg, ref_params, toks = model
    params = T.params_from_reference(_to_numpy(ref_params), cfg, "cpu")
    want, got = _decode_both(ref_cfg, cfg, ref_params, params, toks)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def sparse_model(model):
    ref_cfg, cfg, ref_params, toks = model
    ref_sparse = ref_serve.sparsify_params(ref_params, ref_cfg, 0.8)
    carried = T.params_from_reference(_to_numpy(ref_sparse), cfg, "cpu")
    own = serve.sparsify_params(
        T.params_from_reference(_to_numpy(ref_params), cfg, "cpu"), cfg, 0.8)
    return ref_cfg, cfg, ref_sparse, carried, own, toks


def test_sparsify_params_builds_the_reference_tiles(sparse_model):
    ref_cfg, cfg, ref_sparse, carried, own, _ = sparse_model
    n_bcsr = 0
    for a, b in zip(carried["layers"], own["layers"]):
        for sub in ("mixer", "ffn"):
            for name, w in a[sub].items():
                assert isinstance(b[sub][name], BcsrMatrix) == isinstance(
                    w, BcsrMatrix), name
                if isinstance(w, BcsrMatrix):
                    n_bcsr += 1
                    # same tiles: the carried stack pads KB to the deepest
                    # layer, the port's own banks to this layer's
                    kb = b[sub][name].kb
                    assert torch.equal(w.nblocks, b[sub][name].nblocks)
                    assert torch.equal(w.blocks[:, :kb], b[sub][name].blocks)
                    assert int(w.blocks[:, kb:].count_nonzero()) == 0
    assert n_bcsr == cfg.n_layers * (4 if cfg.qkv_bias else 2) + \
        cfg.n_layers * 3
    assert not isinstance(own["embed"], BcsrMatrix)
    assert not isinstance(own["lm_head"], BcsrMatrix)


def test_sparse_forward_and_decode_match_reference(sparse_model, attn_impl):
    ref_cfg, cfg, ref_sparse, carried, own, toks = sparse_model
    for params in (carried, own):
        want, got = _forward_both(ref_cfg, cfg, ref_sparse, params, toks)
        np.testing.assert_allclose(got, want, **TOL)
    if attn_impl == "chunked":  # decode never reaches full attention
        want, got = _decode_both(ref_cfg, cfg, ref_sparse, own, toks)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, **TOL)


def test_prefill_step_matches_reference(sparse_model, attn_impl):
    ref_cfg, cfg, ref_sparse, carried, _, toks = sparse_model
    want_logits, want_h = ref_steps.make_prefill_step(ref_cfg)(
        ref_sparse, {"tokens": jnp.asarray(toks)})
    got_logits, got_h = steps.make_prefill_step(cfg)(
        carried, {"tokens": torch.from_numpy(toks)})
    assert got_logits.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
