"""The flash-attention forward at head dims 80 (HuBERT-XLarge) and 96
(Phi-3-Vision) against the JAX package's, and the launchers' head-dim
checks.

The same numpy q, k, v go through the reference's ``_fwd_call`` (its
Pallas forward in interpret mode) and the port's launcher on CPU tensors
(the plain version), causal and full, GQA 1:1 and 4:1: O is held to
rtol = atol = 2e-5 (the reference test's own tolerance), lse to 1e-5.

On a CUDA tensor the forward launches its kernel at these dims and the
backward kernels refuse them (``budget.FLASH_BWD_HEAD_DIMS``); the card
tests hold both (``tests/test_torch_kernels_cuda.py``).  Here the
launchers' checks, which run before the device is asked, show which dims
each kernel takes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    assert not {80, 96} & set(budget.FLASH_BWD_HEAD_DIMS)
    assert set(budget.FLASH_BWD_HEAD_DIMS) < set(budget.FLASH_HEAD_DIMS)
    for d in (80, 96):  # the forwards' shared memory, opted in above 48 KB
        assert budget.flash_tc_smem_bytes(d) == 2 * 64 * d * 6
        assert budget.smem_fits(budget.flash_smem_bytes(d))


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


@pytest.mark.parametrize("d", [80, 96])
def test_backward_launchers_refuse_head_dims_80_and_96(d):
    """The dQ and dK/dV launchers check the head dim before the device:
    at 80 and 96 they raise naming the dims they take (on a CUDA tensor
    the same check refuses the launch; no fallback)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, d, seed=3))
    lse = torch.zeros((1, 4, 16))
    for fn in (fk.flash_attention_bwd_dq, fk.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match=f"head dim {d} not one of "
                           rf"\(16, 32, 64, 128\)"):
            fn(q, k, v, q, lse, lse, sc=0.1, causal=True)
    # at 128 the same CPU tensors pass the checks and are refused for
    # their device
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 128, seed=3))
    with pytest.raises(ValueError, match="take CUDA tensors"):
        fk.flash_attention_bwd_dq(q, k, v, q, lse, lse, sc=0.1, causal=True)


@pytest.mark.parametrize("d, ok", [(80, True), (96, True), (48, False),
                                   (112, False)])
def test_forward_launcher_takes_80_and_96(d, ok):
    """The forward launcher's checks (``_launch``, what a CUDA tensor
    reaches) pass at 80 and 96, for bf16 (tensor cores) and f32 (FMA), and
    refuse a head dim no instantiation takes."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _qkv(1, 4, 2, 16, d, seed=4))
        match = "take CUDA tensors" if ok else f"head dim {d} not one of"
        with pytest.raises(ValueError, match=match):
            fk._launch(q, k, v, 0.1, True)
