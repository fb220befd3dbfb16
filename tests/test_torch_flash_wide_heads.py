"""The flash-attention kernels at head dims above 128 against the JAX
package's.

The reference's kernel takes any head dim, and its ``full_attention`` sends
every config with hd == hdv through flash.  The port runs a head dim d
above 128 in the kernels' wide forms (the output-column split): the outputs
are cut into ``budget.flash_slices(d)`` slices of 128 columns, one block
each, and every block sums the score products over all of d in 128-column
d-steps streamed through its shared memory.

* Against the reference: ``jax.grad`` of the reference's
  ``flash_attention`` (its Pallas forward, dQ and dK/dV kernels in
  interpret mode, 16-row chunks, T = 32) against the port's
  ``flash_attention_bthd`` and autograd on CPU tensors (the plain
  versions), at d 160, 256 and 384, causal and full, GQA 4:2, with the
  tolerances of ``tests/test_torch_flash_any_dim.py``: f32 O within
  rtol = atol = 2e-5, dQ, dK, dV within 1e-4; bf16 every output within two
  bf16 units in the last place of the largest of |port|, |reference| and
  the f32 result's rms.
* The wide kernels' own source (``csrc/flash_attention.cu`` compiled with
  g++ over ``tests/_cuda_emu.h``: a block as threads, wgmma emulated) at
  d 160 and 256, all six kernels (the tensor-core and split-TF32 forward,
  dQ and dK/dV, and the group sum), and at d 384 the split-TF32 forward
  and the tensor-core dK/dV: f32 outputs within 1e-5 of the plain
  versions' largest magnitude; bf16 outputs within one bf16 rounding of
  the plain versions' f32 results plus 1e-5 of their largest magnitude
  (the kernels round their f32 sums once, to bf16); every output element
  written (the outputs start as NaN); and with the operands read from,
  and the outputs written into, buffers whose columns past d hold a
  sentinel, which no result may read and no store may touch.
* The transformer: a 2-layer f32 config with head dim 256 (2 heads over
  1 kv head) through flash in both packages: the reference's ``forward``
  and the gradient of its ``loss_fn`` against the port's ``forward`` and
  ``steps.loss_and_grads``, within 1e-4 of max(1, max |reference|) a leaf
  (``tests/test_torch_train.py``'s measure).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_cuda_emu  # noqa: E402
from repro.kernels.flash_attention import kernel as ref_kernel  # noqa: E402
from repro.models import flags as ref_flags  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_bthd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import flags  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

DIMS = [160, 256, 384]
H, KV, T_LEN = 4, 2, 32
O_TOL = dict(rtol=2e-5, atol=2e-5)
G_TOL = dict(rtol=1e-4, atol=1e-4)
EMU_LIMIT = 1e-5
MODEL_TOL = 1e-4   # x max(1, max |reference|), a leaf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (i) against the reference's kernels
# ---------------------------------------------------------------------------

def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, n, T_LEN, d)).astype(np.float32)
               for n in (H, KV, KV))
    co = rng.standard_normal((1, H, T_LEN, d)).astype(np.float32)
    return q, k, v, co


def _reference(q, k, v, co, causal, dtype):
    """O and (dQ, dK, dV) of the reference's kernels, in f32."""
    d = q.shape[-1]

    def loss(q, k, v):
        o = ref_kernel.flash_attention(q, k, v, d ** -0.5, causal, 16, 16,
                                       True)
        return jnp.sum(o.astype(jnp.float32) * co), o

    args = [jnp.asarray(x, dtype=dtype) for x in (q, k, v)]
    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port(q, k, v, co, causal, dtype):
    leaves = [torch.from_numpy(x).to(dtype).transpose(1, 2).requires_grad_()
              for x in (q, k, v)]
    out = flash_attention_bthd(*leaves, causal=causal)
    (out.float() * torch.from_numpy(co).transpose(1, 2)).sum().backward()
    return [x.detach().transpose(1, 2).float().numpy()
            for x in (out, *(leaf.grad for leaf in leaves))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", DIMS)
def test_forward_and_gradients_match_reference(d, causal, dtype):
    q, k, v, co = _inputs(d, seed=d + 10 * causal)
    want = _reference(q, k, v, co, causal, getattr(jnp, dtype))
    got = _port(q, k, v, co, causal, getattr(torch, dtype))
    names = ("o", "dq", "dk", "dv")
    if dtype == "float32":
        for name, g, w, tol in zip(names, got, want,
                                   (O_TOL, G_TOL, G_TOL, G_TOL)):
            np.testing.assert_allclose(g, w, err_msg=name, **tol)
        return
    exact = _reference(q, k, v, co, causal, jnp.float32)
    for name, g, w, x in zip(names, got, want, exact):
        assert np.isfinite(g).all(), name
        rms = float(np.sqrt(np.mean(x ** 2)))
        two_ulp = 2.0 ** -6 * np.maximum(np.maximum(np.abs(g), np.abs(w)),
                                         rms)
        assert bool((np.abs(g - w) <= two_ulp).all()), name


@pytest.mark.parametrize("d", [136, 144, 160, 200, 256, 384, 512])
def test_wide_head_dims_take_the_split(d):
    """Every head dim above 128 runs the wide kernels: ceil(d / 128) slices
    of 128 columns, counted under ``"128xN"``, each kernel's shared memory
    that of 128 columns whatever d (a block never grows with d), and the
    split's products over the math's as the kernels run them."""
    n = -(-d // 128)
    assert budget.flash_wide(d) and budget.flash_slices(d) == n
    assert budget.flash_head_dim(d) == budget.FLASH_WIDE == 128
    assert budget.flash_instance(d) == f"128x{n}"
    for itemsize in (2, 4):
        assert (budget.flash_head_dim_fault(d, itemsize) is None) == (
            d * itemsize % 16 == 0)
    sizes = [f(d) for f in (budget.flash_tc_smem_bytes,
                            budget.flash_bwd_dq_tc_smem_bytes,
                            budget.flash_bwd_dkv_tc_smem_bytes,
                            budget.flash_fwd_tf32_smem_bytes,
                            budget.flash_bwd_dq_smem_bytes,
                            budget.flash_bwd_dkv_smem_bytes)]
    assert all(budget.smem_fits(x) for x in sizes)
    assert sizes == [131_072, 229_376, 214_016, 147_712, 229_632, 205_824]
    # the forward's score product recomputed by each slice, p v over 128
    # columns a slice
    assert budget.flash_split_products(d, 2, 1) == pytest.approx(
        (n * d + n * 128) / (2 * d))
    assert budget.flash_split_products(128, 3, 2) == 1.0


def test_wide_shared_memory_is_the_sources():
    """``budget``'s shared memory of the wide tensor-core kernels is the
    source's ``*_tc_wide_smem_bytes`` at W = 128 (the split-TF32 wide
    kernels keep the D = 128 kernels' formulas, which
    ``tests/test_torch_flash_fwd_tf32.py`` and
    ``tests/test_torch_flash_tf32_split.py`` tie to the source)."""
    src = _torch_cuda_emu.SOURCE.read_text()
    assert "constexpr int WIDE = 128;" in src and budget.FLASH_WIDE == 128
    assert (f"constexpr int WIDE_STAGES = {budget.FLASH_WIDE_STAGES};"
            in src)
    names = {"fwd": budget.flash_tc_smem_bytes,
             "dq": budget.flash_bwd_dq_tc_smem_bytes,
             "dkv": budget.flash_bwd_dkv_tc_smem_bytes}
    for name, fn in names.items():
        expr = re.search(rf"size_t {name}_tc_wide_smem_bytes\(int w\) "
                         rf"\{{\s*return ([^;]+);", src).group(1)
        expr = re.sub(r"static_cast<size_t>\(([^()]*)\)", r"(\1)",
                      " ".join(expr.split()))
        got = eval(expr, {"w": 128, "TC_BQ": 64, "WG": 128, "FWD_WGS": 2,
                          "DQ_WGS": 2,
                          "WIDE_STAGES": budget.FLASH_WIDE_STAGES,
                          "sizeof": lambda _: 4})
        assert got == fn(256) == fn(1024), name


def test_split_products_at_the_issue_dims():
    assert budget.flash_split_products(256, 2, 1) == 1.5
    assert budget.flash_split_products(256, 3, 2) == pytest.approx(5 / 3)
    assert budget.flash_split_products(160, 2, 1) == pytest.approx(1.8)


@pytest.mark.parametrize("d, itemsize", [(132, 2), (130, 4), (250, 2),
                                         (0, 4)])
def test_launchers_refuse_rows_the_copies_cannot_cover(d, itemsize):
    """A head dim whose rows are no multiple of 16 bytes (or below 1) is
    refused at the raw launchers, before the device is asked and before
    any launch; ``ops`` pads such a d first."""
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    q = torch.zeros((1, 4, 16, d), dtype=dtype)
    k = torch.zeros((1, 2, 16, d), dtype=dtype)
    lse = torch.zeros((1, 4, 16))
    match = (f"head dim {d}: a row of {d * itemsize} bytes" if d else
             "head dim 0 below 1")
    with pytest.raises(ValueError, match=match):
        fk._launch(q, k, k, 0.1, True)
    for fn in (fk.flash_attention_bwd_dq, fk.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match=match):
            fn(q, k, k, q, lse, lse, sc=0.1, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_padded_wide_head_dim_through_ops(dtype):
    """d 132 in bf16 (264-byte rows) and 130 in f32 (520): ``ops`` pads
    them to the next multiple of 8 and keeps the first d columns; O and the
    gradients are those of the autograd Function on the unpadded operands
    (on the CPU both run the plain versions, which take any d: the zero
    columns change only the order of f32 sums, so f32 agrees within 1e-5
    and bf16 within one bf16 unit in the last place of the larger side
    plus 1e-5 of the f32 result's rms)."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention

    bf16 = dtype == torch.bfloat16
    d = 132 if bf16 else 130
    assert d * (2 if bf16 else 4) % 16
    gen = torch.Generator().manual_seed(d)
    leaves = [torch.randn((1, 24, n, d), generator=gen).to(dtype)
              for n in (4, 2, 2)]
    w = torch.randn((1, 24, 4, d), generator=gen)
    results = []
    for fn in (lambda q, k, v: flash_attention_bthd(q, k, v, causal=True),
               lambda q, k, v: FlashAttention.apply(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   d ** -0.5, True).transpose(1, 2)):
        q, k, v = [x.clone().requires_grad_() for x in leaves]
        out = fn(q, k, v)
        assert out.shape == (1, 24, 4, d) and out.dtype == dtype
        (out.float() * w).sum().backward()
        results.append([out.detach()] + [x.grad for x in (q, k, v)])
    for name, got, want in zip(("o", "dq", "dk", "dv"), *results):
        got, want = got.float(), want.float()
        if not bf16:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            continue
        rms = float(want.pow(2).mean().sqrt())
        limit = (2.0 ** -7 * torch.maximum(got.abs(), want.abs())
                 + 1e-5 * rms)
        assert bool(((got - want).abs() <= limit).all()), name


# ---------------------------------------------------------------------------
# (ii) the wide kernels' own source, emulated
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = _torch_cuda_emu.emulated_library(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the emulated kernels")
    return lib


def _excess(got, want, bf16) -> float:
    """Over the plain result's largest magnitude: the largest error (f32),
    or the largest error beyond one bf16 rounding of the plain result
    (bf16: the kernel rounds its f32 sums once)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    if bf16:
        err = (err - 2.0 ** -8 * want.abs()).clamp(min=0)
    return float(err.max() / want.abs().max())


def _view(rng, b, n, length, d, dtype):
    # the model's (B, T, H, d) tensors, seen as (B, H, T, d)
    return torch.from_numpy(rng.standard_normal(
        (b, length, n, d)).astype(np.float32)).to(dtype).transpose(1, 2)


def _plain_all(q, k, v, do, sc, causal):
    o, lse = flash_attention_plain(q.float(), k.float(), v.float(), sc=sc,
                                   causal=causal)
    delta = (do.float() * o).sum(-1).contiguous()
    grads = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                      lse, do.float(), sc=sc, causal=causal)
    return o, lse, delta, grads


# (B, H, KV, T, S, d, causal): GQA with its group sum, ragged T, S != T
# (f32: 32-key chunks, bf16: 64)
EMU_CASES = {"float32": [(1, 2, 1, 40, 40, 256, True),
                         (1, 1, 1, 24, 40, 160, False)],
             "bfloat16": [(1, 2, 1, 100, 100, 256, True),
                          (1, 2, 1, 70, 130, 160, False)]}


@pytest.mark.parametrize("dtype, case", [
    (dtype, case) for dtype, cases in EMU_CASES.items() for case in cases],
    ids=str)
def test_wide_kernels_source(emulated, dtype, case):
    """The forward, dQ and dK/dV (and the group sum) of the wide kernels,
    their own source emulated, against the plain versions."""
    b, h, kv, t, s, d, causal = case
    assert budget.flash_wide(d)
    bf16 = dtype == "bfloat16"
    dt = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(t + s + d)
    q, k, v, do = (_view(rng, b, n, length, d, dt)
                   for n, length in ((h, t), (kv, s), (kv, s), (h, t)))
    sc = d ** -0.5
    want_o, want_lse, delta, want = _plain_all(q, k, v, do, sc, causal)
    fwd = _torch_cuda_emu.fwd_tc if bf16 else _torch_cuda_emu.fwd_tf32
    o, lse = fwd(emulated, q, k, v, sc=sc, causal=causal)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert _excess(o, want_o, bf16) <= EMU_LIMIT
    assert float((lse - want_lse).abs().max()) <= EMU_LIMIT
    bwd = _torch_cuda_emu.bwd_tc if bf16 else _torch_cuda_emu.bwd_tf32
    got = bwd(emulated, q, k, v, do, want_lse.contiguous(), delta, sc=sc,
              causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _excess(g, w, bf16) <= EMU_LIMIT, name


def test_wide_f32_forward_at_d384(emulated):
    """Three slices: the split-TF32 forward at d 384 (three d-steps)."""
    b, h, kv, t, d = 1, 1, 1, 40, 384
    rng = np.random.default_rng(d)
    q, k, v = (_view(rng, b, n, t, d, torch.float32) for n in (h, kv, kv))
    sc = d ** -0.5
    o, lse = _torch_cuda_emu.fwd_tf32(emulated, q, k, v, sc=sc, causal=True)
    want_o, want_lse = flash_attention_plain(q, k, v, sc=sc, causal=True)
    assert bool(torch.isfinite(o).all())
    assert _excess(o, want_o, False) <= EMU_LIMIT
    assert float((lse - want_lse).abs().max()) <= EMU_LIMIT


def test_wide_bf16_dkv_at_d384(emulated):
    """Three slices: the tensor-core dK/dV and its group sum at d 384."""
    b, h, kv, t, d = 1, 2, 1, 64, 384
    rng = np.random.default_rng(d + 1)
    q, k, v, do = (_view(rng, b, n, t, d, torch.bfloat16)
                   for n in (h, kv, kv, h))
    sc = d ** -0.5
    _, lse, delta, want = _plain_all(q, k, v, do, sc, False)
    dk = torch.full_like(k, float("nan"))
    dv = torch.full_like(v, float("nan"))
    parts = [torch.full((b, h, t, d), float("nan")) for _ in range(2)]
    err = _torch_cuda_emu._entry(emulated, "flash_attention_bwd_dkv_tc", 10,
                                 6)(
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv, *parts)),
        b, h, kv, t, t, d, *_torch_cuda_emu._strides(q, k, v, do, dk, dv),
        sc, 0, 1, None)
    assert err == 0
    for name, g, w in (("dk", dk, want[1]), ("dv", dv, want[2])):
        assert bool(torch.isfinite(g).all()), name
        assert _excess(g, w, True) <= EMU_LIMIT, name


SENTINEL = 7.0


def _padded(rng, b, n, length, d, width, dtype):
    """(B, H, T, d) view of a (B, T, H, width) buffer whose columns
    [d, width) hold SENTINEL, and the buffer."""
    buf = torch.full((b, length, n, width), SENTINEL, dtype=dtype)
    buf[..., :d] = torch.from_numpy(rng.standard_normal(
        (b, length, n, d)).astype(np.float32)).to(dtype)
    return buf[..., :d].transpose(1, 2), buf


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_columns_past_the_head_dim_are_neither_read_nor_written(emulated,
                                                                dtype):
    """d 160 (its last slice 32 columns wide) with the operands and outputs
    as views of buffers as wide as the slices (256 columns), a sentinel in
    the columns past d: the results are the plain versions', so no
    sentinel was read, and every sentinel is still there, so no store
    reached it (the group sum at H > KV)."""
    d, width = 160, 128 * budget.flash_slices(160)
    bf16 = dtype == torch.bfloat16
    b, h, kv, t = 1, 2, 1, 40 if bf16 else 24
    rng = np.random.default_rng(d + bf16)
    (q, _), (k, _), (v, _), (do, _) = (
        _padded(rng, b, n, t, d, width, dtype) for n in (h, kv, kv, h))
    o, obuf = _padded(rng, b, h, t, d, width, dtype)
    dq, dqbuf = _padded(rng, b, h, t, d, width, dtype)
    dk, dkbuf = _padded(rng, b, kv, t, d, width, dtype)
    dv, dvbuf = _padded(rng, b, kv, t, d, width, dtype)
    lse = torch.full((b, h, t), float("nan"))
    sc = d ** -0.5
    code = 1 if bf16 else 0
    tc = "_tc" if bf16 else ""
    entry = _torch_cuda_emu._entry
    strides = _torch_cuda_emu._strides
    assert entry(emulated, f"flash_attention_fwd{tc}", 5, 4)(
        *(x.data_ptr() for x in (q, k, v, o, lse)), b, h, kv, t, t, d,
        *strides(q, k, v, o), sc, 1, code, None) == 0
    want_o, want_lse, _, _ = _plain_all(q, k, v, do, sc, True)
    assert _excess(o, want_o, bf16) <= EMU_LIMIT
    assert float((lse - want_lse).abs().max()) <= EMU_LIMIT
    delta = (do.float() * o.float()).sum(-1).contiguous()
    assert entry(emulated, f"flash_attention_bwd_dq{tc}", 7, 5)(
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, dq)), b, h, kv, t,
        t, d, *strides(q, k, v, do, dq), sc, 1, code, None) == 0
    parts = [torch.full((b, h, t, d), float("nan")) for _ in range(2)]
    assert entry(emulated, f"flash_attention_bwd_dkv{tc}", 10, 6)(
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv, *parts)),
        b, h, kv, t, t, d, *strides(q, k, v, do, dk, dv), sc, 1, code,
        None) == 0
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), sc=sc,
                                     causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _excess(g, w, bf16) <= EMU_LIMIT, name
    for name, buf in (("o", obuf), ("dq", dqbuf), ("dk", dkbuf),
                      ("dv", dvbuf)):
        assert bool((buf[..., d:] == SENTINEL).all()), name


# ---------------------------------------------------------------------------
# (iii) the transformer at head dim 256
# ---------------------------------------------------------------------------

WIDE256 = dict(name="wide256", family="dense", n_layers=2, d_model=512,
               vocab=64, n_heads=2, n_kv_heads=1, head_dim=256, d_ff=256,
               dtype="float32")


@pytest.fixture
def flash():
    ref_flags.set_attn_impl("flash")
    flags.set_attn_impl("flash")
    yield
    ref_flags.set_attn_impl("chunked")
    flags.set_attn_impl("chunked")


def _close(got, want, what):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    limit = MODEL_TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: max |port - reference| {err} > {limit}"


def test_transformer_at_head_dim_256_matches_reference(flash):
    ref_cfg, cfg = RefModelConfig(**WIDE256), ModelConfig(**WIDE256)
    assert budget.flash_wide(cfg.head_dim)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(3))
    params = T.params_from_reference(jax.tree.map(np.asarray, ref_params),
                                     cfg, "cpu")
    batch = SyntheticLMDataset(DataConfig(seq_len=T_LEN, global_batch=2,
                                          vocab=cfg.vocab,
                                          seed=6)).batch_for(0)
    toks, labels = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    want_logits, _ = RT.forward(ref_params, toks, ref_cfg)
    got_logits, _ = T.forward(params, torch.from_numpy(batch["tokens"]), cfg)
    _close(got_logits.detach().numpy(), np.asarray(want_logits), "logits")
    want, ref_grads = jax.value_and_grad(
        lambda p: RT.loss_fn(p, toks, labels, ref_cfg))(ref_params)
    got, grads = steps.loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(float(got), float(want), "loss")
    want_grads = dict(tree_paths(T.params_from_reference(
        jax.tree.map(np.asarray, ref_grads), cfg, "cpu")))
    paths = [path for path, _ in tree_paths(params)]
    assert len(paths) == len(grads) == len(want_grads)
    for path, g in zip(paths, grads):
        _close(g.numpy(), want_grads[path].numpy(), f"grad {path}")
