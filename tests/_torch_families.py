"""What the family test files share (``test_torch_families*.py``): each of
the reference's six non-dense archs at its smoke config, cast to f32, its
params drawn with ``jax.random`` and carried over with
``params_from_reference``, the same inputs through both packages.

Held to rtol = atol = 1e-4 (f32 throughout; sums run in other orders):
``forward`` logits (``forward_embeds`` for the encoder and the VLM) at
T = 128, a multiple of the reference flash kernel's chunk, so that its
interpret-mode Pallas kernel writes every row; 16 ``decode_step``s (every
arch but the encoder): the same argmax tokens and logits; both again with
the weights at sparsity 0.8, the reference's ``sparsify_params`` carried
over and the port's own on the carried dense weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import serving as ref_serving
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import flags as ref_flags
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.core.sparse_format import BcsrMatrix
from repro_torch.launch import serve, steps
from repro_torch.models import flags
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine
from repro_torch.tree import tree_paths

TOL = dict(rtol=1e-4, atol=1e-4)
B, T_FWD, N_DECODE = 2, 128, 16
SPARSITY = 0.8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def moe_flags():
    """Both packages at the default capacity factor, the reference's on
    its gather MoE (another test file may leave the reference's capacity
    changed)."""
    saved = (ref_flags.MOE_CAPACITY, ref_flags.MOE_IMPL, flags.MOE_CAPACITY)
    ref_flags.set_moe_capacity(1.25)
    ref_flags.set_moe_impl("gather")
    flags.set_moe_capacity(1.25)
    yield
    ref_flags.MOE_CAPACITY, ref_flags.MOE_IMPL = saved[:2]
    flags.MOE_CAPACITY = saved[2]


@pytest.fixture(params=["chunked", "flash"])
def attn_impl(request):
    ref_flags.set_attn_impl(request.param)
    flags.set_attn_impl(request.param)
    yield request.param
    ref_flags.set_attn_impl("chunked")
    flags.set_attn_impl("chunked")


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@dataclasses.dataclass
class Model:
    ref_cfg: object
    cfg: object
    ref_params: dict
    params: dict            # the reference's, carried over
    toks: np.ndarray        # (B, T_FWD) ids
    embeds: np.ndarray      # (B, T_FWD, D) for the encoder and the VLM

    @property
    def uses_embeds(self) -> bool:
        return self.cfg.family in ("vlm", "encoder")


def make_model(arch: str, seed: int = 0) -> Model:
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab, (B, T_FWD), dtype=np.int32)
    embeds = rng.standard_normal((B, T_FWD, cfg.d_model)).astype(np.float32)
    return Model(ref_cfg, cfg, ref_params,
                 T.params_from_reference(to_numpy(ref_params), cfg, "cpu"),
                 toks, embeds)


def forward_both(m: Model, ref_params, params):
    if m.uses_embeds:
        want, _ = RT.forward_embeds(ref_params, jnp.asarray(m.embeds),
                                    m.ref_cfg)
        got, _ = T.forward_embeds(params, torch.from_numpy(m.embeds), m.cfg)
    else:
        want, _ = RT.forward(ref_params, jnp.asarray(m.toks), m.ref_cfg)
        got, _ = T.forward(params, torch.from_numpy(m.toks), m.cfg)
    assert got.shape == (B, T_FWD, m.cfg.vocab)
    return np.asarray(want), got.numpy()


def decode_both(m: Model, ref_params, params, n: int = N_DECODE):
    ref_cfg, cfg = m.ref_cfg, m.cfg
    step = jax.jit(lambda p, t, c, l: RT.decode_step(p, ref_cfg, t, c, l))
    rc = RT.init_cache(ref_cfg, B, n)
    pc = T.init_cache(cfg, B, n, "cpu")
    want, got = [], []
    for i in range(n):
        lg, rc = step(ref_params, jnp.asarray(m.toks[:, i:i + 1]), rc,
                      jnp.int32(i))
        want.append(np.asarray(lg))
        lg, pc = T.decode_step(params, cfg,
                               torch.from_numpy(m.toks[:, i:i + 1]), pc, i)
        got.append(lg.numpy())
    return np.stack(want, 1), np.stack(got, 1)


def sparse_pair(m: Model, min_dim: int = 64):
    """(the reference's sparse params, carried over, the port's own
    ``sparsify_params`` on the carried dense params)."""
    ref_sparse = ref_serve.sparsify_params(m.ref_params, m.ref_cfg, SPARSITY,
                                           min_dim=min_dim)
    carried = T.params_from_reference(to_numpy(ref_sparse), m.cfg, "cpu")
    own = serve.sparsify_params(
        T.params_from_reference(to_numpy(m.ref_params), m.cfg, "cpu"), m.cfg,
        SPARSITY, min_dim=min_dim)
    return ref_sparse, carried, own


# -- the checks each family file runs on its archs ------------------------

def check_params_carry_over(m: Model):
    """One params dict a layer; every leaf keeps the reference's dtype (the
    f32 router and Mamba2 leaves too) and the port's own ``init_params``
    draws the same tree: the same paths, shapes and dtypes."""
    assert len(m.params["layers"]) == m.cfg.n_layers
    own = T.init_params(m.cfg, torch.Generator().manual_seed(0), "cpu")
    carried = dict(tree_paths(m.params))
    drawn = dict(tree_paths(own))
    assert sorted(carried) == sorted(drawn)
    for path, leaf in carried.items():
        assert tuple(leaf.shape) == tuple(drawn[path].shape), path
        assert leaf.dtype == drawn[path].dtype, path
    descs = T.layer_descs(m.cfg)
    for desc, layer in zip(descs, m.params["layers"]):
        if desc.ffn == "moe":
            e = m.cfg.n_experts
            assert layer["ffn"]["w_gate"].shape[0] == e
            assert layer["ffn"]["router"].dtype == torch.float32
        if desc.kind == "ssm":
            for name in ("a_log", "d_skip", "dt_bias"):
                assert layer["mixer"][name].dtype == torch.float32


def check_forward(m: Model):
    want, got = forward_both(m, m.ref_params, m.params)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def check_decode(m: Model, ref_params=None, params=None):
    want, got = decode_both(m, m.ref_params if ref_params is None
                            else ref_params,
                            m.params if params is None else params)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, **TOL)


def check_sparse_leaves(carried, own) -> int:
    """The port's ``sparsify_params`` converts the leaves the reference's
    does, with the same tiles (the carried stack pads KB to its deepest
    layer, the port's own banks to each layer's); returns the count."""
    a, b = dict(tree_paths(carried)), dict(tree_paths(own))
    assert sorted(a) == sorted(b)
    n = 0
    for path, w in a.items():
        assert isinstance(b[path], BcsrMatrix) == isinstance(w, BcsrMatrix), \
            path
        if isinstance(w, BcsrMatrix):
            n += 1
            kb = b[path].kb
            assert torch.equal(w.nblocks, b[path].nblocks), path
            assert torch.equal(w.blocks[:, :kb], b[path].blocks), path
            assert int(w.blocks[:, kb:].count_nonzero()) == 0, path
    return n


def check_sparse_forward(m: Model, pair):
    ref_sparse, carried, own = pair
    for params in (carried, own):
        want, got = forward_both(m, ref_sparse, params)
        np.testing.assert_allclose(got, want, **TOL)


def check_prefill_step(m: Model, pair):
    ref_sparse, carried, _ = pair
    key = "embeds" if m.uses_embeds else "tokens"
    x = m.embeds if m.uses_embeds else m.toks
    want_logits, want_h = ref_steps.make_prefill_step(m.ref_cfg)(
        ref_sparse, {key: jnp.asarray(x)})
    got_logits, got_h = steps.make_prefill_step(m.cfg)(
        carried, {key: torch.from_numpy(x)})
    assert got_logits.shape == (B, m.cfg.vocab)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def _requests(cls, vocab, seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, int(rng.integers(2, 6))).tolist(),
                max_new_tokens=int(rng.integers(3, 7))) for i in range(n)]


def check_serve_engine(m: Model, ref_params, params):
    """``ServeEngine`` in both packages over the same requests: the same
    tokens for every request, tick for tick.  The reference's engine
    resets only its shared write cursor between waves, never a slot's
    recurrent (Mamba2) state; the port's mirrors that."""
    n_slots, max_len = 3, 20
    ref_eng = ref_serving.ServeEngine(
        jax.jit(ref_steps.make_serve_step(m.ref_cfg)), ref_params,
        RT.init_cache(m.ref_cfg, n_slots, max_len), n_slots, max_len)
    eng = ServeEngine(steps.make_serve_step(m.cfg), params,
                      T.init_cache(m.cfg, n_slots, max_len, "cpu"), n_slots,
                      max_len, device="cpu")
    ref_reqs = _requests(ref_serving.Request, m.cfg.vocab)
    reqs = _requests(Request, m.cfg.vocab)
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


def check_serve_cli(arch: str, capsys):
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "4", "--gen", "3", "--sparsity", str(SPARSITY), "--device",
                "cpu"])
    out = capsys.readouterr().out
    assert f"Escoin BCSR weights at sparsity {SPARSITY}" in out
    assert "generated 3 tokens x 2 seqs on cpu" in out
