"""The flash-attention forward and backward at head dims 80 (HuBERT-XLarge)
and 96 (Phi-3-Vision) against the JAX package's, and the launchers'
head-dim checks.

The same numpy q, k, v go through the reference's ``_fwd_call`` (its
Pallas forward in interpret mode) and the port's launcher on CPU tensors
(the plain version), causal and full, GQA 1:1 and 4:1: O is held to
rtol = atol = 2e-5 (the reference test's own tolerance), lse to 1e-5.

The backward: ``jax.grad`` of the reference's ``flash_attention`` (its
Pallas forward, dQ and dK/dV kernels in interpret mode, T = 32 = two
chunks of 16) against the port's ``flash_attention_bthd`` on CPU tensors
(its autograd Function: the plain forward and backward), causal and
bidirectional, MHA (H = KV = 2) and GQA (H 4, KV 2): f32 dQ, dK, dV within
rtol = atol = 1e-4 (the reference's gradient tolerance); bf16 within two
bf16 units in the last place (2^-6) of the largest of |port|, |reference|
and the f32 gradient's rms: each side rounds its f32 sums once, and the
port recomputes its own bf16 O, which may differ from the reference's by
one rounding and reaches every gradient through delta = rowsum(dO O).
The rms floor covers elements that cancel to near zero (a causal first
row's dQ: ds = dp - delta with p = 1), whose error follows the row's scale,
not their own; the f32 gradients of the same inputs lie ~1e-2 from both
sides (the inputs' bf16 rounding), well beyond this.

On a CUDA tensor every kernel launches at these dims; the card tests hold
them (``tests/test_torch_kernels_cuda.py``).  Here the launchers' checks,
which run before the device is asked, show which dims each kernel takes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as ref_kernel  # noqa: E402
from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_bthd  # noqa: E402

O_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(b, h, kv, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, t, d)).astype(np.float32),
            rng.standard_normal((b, kv, t, d)).astype(np.float32),
            rng.standard_normal((b, kv, t, d)).astype(np.float32))


def test_forward_and_backward_head_dims():
    assert {80, 96} <= set(budget.FLASH_HEAD_DIMS)
    for d in (80, 96):  # shared memory, opted in above 48 KB
        assert budget.flash_tc_smem_bytes(d) == 2 * 64 * d * 6
        assert budget.flash_bwd_dq_tc_smem_bytes(d) == 2 * 64 * d * 8
        assert budget.flash_bwd_dkv_tc_smem_bytes(d) == (
            2 * 64 * d * 6 + 4 * (2 * 2 * 64 + 32 * 128))
        for nbytes in (budget.flash_fwd_tf32_smem_bytes(d),
                       budget.flash_bwd_dq_smem_bytes(d),
                       budget.flash_bwd_dkv_smem_bytes(d),
                       budget.flash_bwd_dq_tc_smem_bytes(d),
                       budget.flash_bwd_dkv_tc_smem_bytes(d)):
            assert budget.smem_fits(nbytes)


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("h, kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference_kernel(d, h, kv, causal):
    t = 64
    q, k, v = _qkv(2, h, kv, t, d, seed=d + h + causal)
    sc = d ** -0.5
    want_o, want_lse = ref_kernel._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sc=sc, causal=causal,
        cq=t, ck=t, interpret=True)
    got_o, got_lse = fk.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), sc=sc,
        causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **O_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_model_layout_at_head_dims_80_and_96(d, causal):
    """T = 128, the reference's own chunk: the (B, T, H, d) wrapper of
    both packages, GQA 2:1."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 128, 4, d)).astype(np.float32)
    k = rng.standard_normal((1, 128, 2, d)).astype(np.float32)
    v = rng.standard_normal((1, 128, 2, d)).astype(np.float32)
    want = ref_ops.flash_attention_bthd(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        interpret=True)
    got = flash_attention_bthd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)


@pytest.mark.parametrize("d", [80, 96])
def test_cpu_backward_runs_the_plain_version(d):
    """On CPU tensors the autograd Function's backward is the plain one at
    any head dim: gradients against autograd through ``attention_ref``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator().manual_seed(d)
    leaves = [torch.randn(shape, generator=gen) for shape in
              ((1, 40, 4, d), (1, 40, 2, d), (1, 40, 2, d))]
    w = torch.randn((1, 40, 4, d), generator=gen)
    grads = []
    for fn in (lambda q, k, v: flash_attention_bthd(q, k, v, causal=True),
               lambda q, k, v: attention_ref(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   causal=True).transpose(1, 2)):
        q, k, v = [x.clone().requires_grad_() for x in leaves]
        (fn(q, k, v) * w).sum().backward()
        grads.append([x.grad for x in (q, k, v)])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d, ok", [(80, True), (96, True), (48, True),
                                   (112, True), (24, True), (144, False),
                                   (256, False)])
def test_backward_launchers_take_80_and_96_only_listed_dims(d, ok):
    """The dQ and dK/dV launchers check the head dim before the device:
    at any head dim up to 128 (80 and 96, and 24, 48 and 112, which run in
    the instantiations 32, 64 and 128) the CPU tensors pass the checks and
    are refused for their device only; above 128 (144, 256) they raise
    naming 128, the largest the kernels are built for (on a CUDA tensor
    the same check refuses the launch; no fallback)."""
    lse = torch.zeros((1, 4, 16))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _qkv(1, 4, 2, 16, d, seed=3))
        match = ("take CUDA tensors" if ok else
                 f"head dim {d} outside 1 .. 128")
        for fn in (fk.flash_attention_bwd_dq, fk.flash_attention_bwd_dkv):
            with pytest.raises(ValueError, match=match):
                fn(q, k, v, q, lse, lse, sc=0.1, causal=True)


def _reference_grads(q, k, v, co, *, causal, dtype):
    d = q.shape[-1]

    def loss(q, k, v):
        o = ref_kernel.flash_attention(q, k, v, d ** -0.5, causal, 16, 16,
                                       True)
        return jnp.sum(o.astype(jnp.float32) * co)

    args = [jnp.asarray(x, dtype=dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32)) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, co, *, causal, dtype):
    leaves = [torch.from_numpy(x).to(dtype).transpose(1, 2).requires_grad_()
              for x in (q, k, v)]
    out = flash_attention_bthd(*leaves, causal=causal)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == \
        "FlashAttentionBackward"
    (out.float() * torch.from_numpy(co).transpose(1, 2)).sum().backward()
    return [x.grad.transpose(1, 2).float().numpy() for x in leaves]


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("h, kv", [(2, 2), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_reference_kernel(d, h, kv, causal, dtype):
    q, k, v = _qkv(1, h, kv, 32, d, seed=d + h + kv + causal)
    co = np.random.default_rng(d + 7).standard_normal(q.shape).astype(
        np.float32)
    want = _reference_grads(q, k, v, co, causal=causal,
                            dtype=getattr(jnp, dtype))
    got = _port_grads(q, k, v, co, causal=causal,
                      dtype=getattr(torch, dtype))
    exact = (want if dtype == "float32" else
             _reference_grads(q, k, v, co, causal=causal, dtype=jnp.float32))
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        else:
            rms = float(np.sqrt(np.mean(x ** 2)))
            two_ulp = 2.0 ** -6 * np.maximum(np.maximum(np.abs(g), np.abs(w)),
                                             rms)
            assert bool((np.abs(g - w) <= two_ulp).all()), name


@pytest.mark.parametrize("d, ok", [(80, True), (96, True), (48, True),
                                   (112, True), (24, True), (144, False),
                                   (256, False)])
def test_forward_launcher_takes_80_and_96(d, ok):
    """The forward launcher's checks (``_launch``, what a CUDA tensor
    reaches) pass at 80 and 96 and at any other head dim up to 128, for
    bf16 (tensor cores) and f32 (split TF32), and refuse a head dim above
    128."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _qkv(1, 4, 2, 16, d, seed=4))
        match = "take CUDA tensors" if ok else f"head dim {d} outside"
        with pytest.raises(ValueError, match=match):
            fk._launch(q, k, v, 0.1, True)
