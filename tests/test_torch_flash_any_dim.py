"""The flash-attention kernels at any head dim up to 128 against the JAX
package's.

The reference's kernel takes any head dim (``choose_chunks`` only sizes its
chunks).  The port's kernels are instantiated at D = 16, 32, 64, 80, 96 and
128 and run a head dim d in the smallest D >= d, the columns [d, D) zero on
chip and never stored (``budget.flash_head_dim``); ``ops`` pads a d whose
rows are no multiple of 16 bytes (20 in bf16) to the next multiple of 8.

* The forward and the gradients: ``jax.grad`` of the reference's
  ``flash_attention`` (its Pallas forward, dQ and dK/dV kernels in
  interpret mode; T = 32, two of its 16-row chunks, since its ragged tail
  is NaN) against the port's ``flash_attention_bthd`` and autograd on CPU
  tensors (the plain versions, through ``ops``' padding where it pads), at
  d 8, 20, 24, 40, 48 and 112, causal and full, GQA 4:2.  f32: O within
  rtol = atol = 2e-5 (the reference test's tolerance), dQ, dK, dV within
  1e-4 (its gradient tolerance); bf16: every output within two bf16 units
  in the last place (2^-6) of the largest of |port|, |reference| and the
  f32 result's rms (each side rounds its f32 sums once; the rms floor
  covers elements that cancel to near zero).
* The split-TF32 kernels' own source (``csrc/flash_attention.cu``,
  compiled with g++ over ``tests/_cuda_emu.h``: a block as threads, wgmma
  emulated) at d 20, 24, 40 and 48, so that the predicated loads and
  stores run here: O, lse, dQ, dK, dV within 1e-5 of the plain versions'
  largest magnitude, every output element written (the outputs start as
  NaN); and with q, k, v, dO read from, and O, dQ, dK, dV written into,
  buffers whose columns [d, D) hold a sentinel, which no output may read
  and no store may touch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_cuda_emu  # noqa: E402
from repro.kernels.flash_attention import kernel as ref_kernel  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_bthd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain)

DIMS = [8, 20, 24, 40, 48, 112]
H, KV, T = 4, 2, 32
O_TOL = dict(rtol=2e-5, atol=2e-5)
G_TOL = dict(rtol=1e-4, atol=1e-4)
EMU_LIMIT = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, n, T, d)).astype(np.float32)
               for n in (H, KV, KV))
    co = rng.standard_normal((1, H, T, d)).astype(np.float32)
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
    """O and (dQ, dK, dV) of ``flash_attention_bthd`` on the model's
    (B, T, H, d) layout, in f32, (B, H, T, d) like the reference's."""
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


@pytest.mark.parametrize("d", DIMS + [128])
def test_instantiation_and_padding_of_each_head_dim(d):
    """The instantiation a head dim runs in, and whether ``ops`` pads it
    first: only where a row of d elements is no multiple of 16 bytes."""
    inst = budget.flash_head_dim(d)
    assert inst in budget.FLASH_HEAD_DIMS and inst >= d
    assert all(dim < d for dim in budget.FLASH_HEAD_DIMS if dim < inst)
    for itemsize in (2, 4):
        fault = budget.flash_head_dim_fault(d, itemsize)
        assert (fault is None) == (d * itemsize % 16 == 0), (d, itemsize)
    for nbytes in (budget.flash_tc_smem_bytes(d),
                   budget.flash_bwd_dkv_smem_bytes(d)):
        assert budget.smem_fits(nbytes)
    assert budget.flash_tc_smem_bytes(d) == budget.flash_tc_smem_bytes(inst)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = _torch_cuda_emu.emulated_library(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the emulated kernels")
    return lib


def _over_max(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


# (B, H, KV, T, S, d, causal): instantiations 32 and 64 from below, GQA
# with its group sum, ragged T, S != T
EMU_CASES = [(1, 4, 2, 100, 100, 24, True),
             (1, 2, 1, 70, 130, 48, False),
             (1, 2, 2, 64, 64, 20, True),
             (1, 4, 2, 96, 80, 40, False)]


def _view(rng, b, n, length, d):
    # the model's (B, T, H, d) tensors, seen as (B, H, T, d)
    return torch.from_numpy(rng.standard_normal(
        (b, length, n, d)).astype(np.float32)).transpose(1, 2)


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_split_tf32_source_at_any_head_dim(emulated, case):
    b, h, kv, t, s, d, causal = case
    rng = np.random.default_rng(t + s + d)
    q, k, v, do = (_view(rng, b, n, length, d)
                   for n, length in ((h, t), (kv, s), (kv, s), (h, t)))
    sc = d ** -0.5
    o, lse = _torch_cuda_emu.fwd_tf32(emulated, q, k, v, sc=sc,
                                      causal=causal)
    want_o, want_lse = flash_attention_plain(q, k, v, sc=sc, causal=causal)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert _over_max(o, want_o) <= EMU_LIMIT
    assert float((lse - want_lse).abs().max()) <= EMU_LIMIT
    delta = (do * want_o).sum(-1).contiguous()
    got = _torch_cuda_emu.bwd_tf32(emulated, q, k, v, do,
                                   want_lse.contiguous(), delta, sc=sc,
                                   causal=causal)
    want = flash_attention_bwd_plain(q, k, v, want_o, want_lse, do, sc=sc,
                                     causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _over_max(g, w) <= EMU_LIMIT, name


SENTINEL = 7.0


def _padded(rng, b, n, length, d, width):
    """(B, H, T, d) view of a (B, T, H, width) buffer whose columns
    [d, width) hold SENTINEL, and the buffer."""
    buf = torch.full((b, length, n, width), SENTINEL)
    buf[..., :d] = torch.from_numpy(rng.standard_normal(
        (b, length, n, d)).astype(np.float32))
    return buf[..., :d].transpose(1, 2), buf


@pytest.mark.parametrize("d", [20, 24, 48])
def test_columns_past_the_head_dim_are_neither_read_nor_written(emulated, d):
    """The operands and outputs as views of buffers as wide as the
    instantiation, with a sentinel in the columns past d: the results are
    the plain versions', so no sentinel was read, and every sentinel is
    still there, so no store reached it (f32; the group sum at H > KV)."""
    width = budget.flash_head_dim(d)
    b, h, kv, t = 1, 4, 2, 70
    rng = np.random.default_rng(d)
    (q, _), (k, _), (v, _), (do, _) = (
        _padded(rng, b, n, t, d, width) for n in (h, kv, kv, h))
    o, obuf = _padded(rng, b, h, t, d, width)
    dq, dqbuf = _padded(rng, b, h, t, d, width)
    dk, dkbuf = _padded(rng, b, kv, t, d, width)
    dv, dvbuf = _padded(rng, b, kv, t, d, width)
    lse = torch.full((b, h, t), float("nan"))
    sc = d ** -0.5
    strides = [st for x in (q, k, v, o) for st in x.stride()[:3]]
    fwd = _torch_cuda_emu._entry(emulated, "flash_attention_fwd", 5, 4)
    assert fwd(*(x.data_ptr() for x in (q, k, v, o, lse)), b, h, kv, t, t,
               d, *strides, sc, 1, 0, None) == 0
    want_o, want_lse = flash_attention_plain(q, k, v, sc=sc, causal=True)
    assert _over_max(o, want_o) <= EMU_LIMIT
    assert float((lse - want_lse).abs().max()) <= EMU_LIMIT
    delta = (do * o).sum(-1).contiguous()
    strides = [st for x in (q, k, v, do, dq) for st in x.stride()[:3]]
    dq_fn = _torch_cuda_emu._entry(emulated, "flash_attention_bwd_dq", 7, 5)
    assert dq_fn(*(x.data_ptr() for x in (q, k, v, do, lse, delta, dq)), b,
                 h, kv, t, t, d, *strides, sc, 1, 0, None) == 0
    parts = [torch.full((b, h, t, d), float("nan")) for _ in range(2)]
    assert _torch_cuda_emu.dkv_tf32(emulated, q, k, v, do, lse, delta, dk,
                                    dv, *parts, sc=sc, causal=True) == 0
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, sc=sc, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _over_max(g, w) <= EMU_LIMIT, name
    for name, buf in (("o", obuf), ("dq", dqbuf), ("dk", dkbuf),
                      ("dv", dvbuf)):
        assert bool((buf[..., d:] == SENTINEL).all()), name
