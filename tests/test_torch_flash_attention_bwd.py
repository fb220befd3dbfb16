"""The port's flash-attention backward against the JAX package's.

The same numpy q, k, v and output cotangent go through ``jax.grad`` of the
reference's ``flash_attention`` (its ``custom_vjp``: the Pallas forward and
the dQ and dK/dV kernels in interpret mode) and through the port's
``flash_attention_bthd`` on CPU tensors, whose autograd Function runs the
plain versions of the forward and of both backward kernels.

* The reference's own gradient cases (``tests/test_kernels_flash_attention.py``:
  MHA, GQA 2:1, MQA, bidirectional, cq != ck) in f32: dQ, dK and dV held to
  rtol = atol = 1e-4, the reference's tolerance for its gradients.
* bf16 (GQA 2:1): both sides round each gradient once from f32 sums taken
  in other orders, and the port recomputes its own bf16 O, which the
  reference's may differ from by one rounding, so every element is held to
  one bf16 unit in the last place of the larger side (2^-7 of it).
* Ragged T = 200, where the reference's kernel leaves rows 128-199
  unwritten (ROADMAP Queue 3): the port against ``torch.autograd`` through
  ``attention_ref``, rtol = atol = 1e-4.
* ``flash_attention_bwd_plain`` against ``torch.autograd`` through
  ``flash_attention_plain``: rtol = atol = 1e-5 (the same f32 products).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_bthd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_bwd_plain, flash_attention_plain)

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# (B, H, KV, T, S, d, causal, cq, ck): the reference's gradient cases
CASES = [
    (1, 4, 4, 32, 32, 16, True, 16, 16),
    (2, 4, 2, 64, 64, 16, True, 16, 16),    # GQA g=2
    (1, 8, 1, 32, 32, 8, True, 8, 8),       # MQA
    (2, 2, 2, 32, 32, 16, False, 16, 16),   # bidirectional
    (1, 4, 4, 64, 64, 32, True, 32, 64),    # cq != ck
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, h, kv, t, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, t, d), (b, kv, s, d), (b, kv, s, d), (b, h, t, d))]


def _reference_grads(q, k, v, co, *, causal, cq, ck, dtype=jnp.float32):
    d = q.shape[-1]

    def loss(q, k, v):
        o = flash_attention(q, k, v, d ** -0.5, causal, cq, ck, True)
        return jnp.sum(o.astype(jnp.float32) * co)

    args = [jnp.asarray(x, dtype=dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32)) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, co, *, causal, dtype=torch.float32):
    """Gradients through ``flash_attention_bthd`` on the model's
    (B, T, H, d) layout, returned in the kernels' (B, H, T, d)."""
    leaves = [torch.from_numpy(x).to(dtype).transpose(1, 2).requires_grad_()
              for x in (q, k, v)]
    out = flash_attention_bthd(*leaves, causal=causal)
    # the backward is the Function's (the plain dQ and dK/dV on the CPU),
    # not autograd through the plain forward
    node = out.grad_fn.next_functions[0][0]
    assert type(node).__name__ == "FlashAttentionBackward"
    (out.float() * torch.from_numpy(co).transpose(1, 2)).sum().backward()
    return [x.grad.transpose(1, 2).float().numpy() for x in leaves]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_grads_match_reference_kernel(case):
    b, h, kv, t, s, d, causal, cq, ck = case
    q, k, v, co = _inputs(b, h, kv, t, s, d, seed=t + h + kv + d)
    want = _reference_grads(q, k, v, co, causal=causal, cq=cq, ck=ck)
    got = _port_grads(q, k, v, co, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def test_bf16_grads_match_reference_kernel():
    q, k, v, co = _inputs(1, 4, 2, 32, 32, 16, seed=11)
    want = _reference_grads(q, k, v, co, causal=True, cq=16, ck=16,
                            dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, co, causal=True, dtype=torch.bfloat16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        ulp = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
        assert bool((np.abs(g - w) <= ulp).all()), name


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_autograd_of_attention_ref(causal):
    q, k, v, co = _inputs(2, 4, 2, 200, 200, 16, seed=200 + causal)
    got = _port_grads(q, k, v, co, causal=causal)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, causal=causal)
    (out * torch.from_numpy(co)).sum().backward()
    for name, g, x in zip(("dq", "dk", "dv"), got, leaves):
        np.testing.assert_allclose(g, x.grad.numpy(), err_msg=name,
                                   **GRAD_TOL)


# (B, H, KV, T, S, d, causal)
PLAIN_CASES = [(2, 4, 2, 24, 24, 16, True), (1, 6, 1, 17, 17, 8, True),
               (1, 4, 4, 12, 20, 16, False), (2, 4, 2, 30, 19, 16, True)]


@pytest.mark.parametrize("case", PLAIN_CASES, ids=str)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    b, h, kv, t, s, d, causal = case
    q, k, v, do = [torch.from_numpy(x) for x in
                   _inputs(b, h, kv, t, s, d, seed=sum(case))]
    sc = d ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_plain(*leaves, sc=sc, causal=causal)
    (o * do).sum().backward()
    got = flash_attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do,
                                    sc=sc, causal=causal)
    for name, g, x in zip(("dq", "dk", "dv"), got, leaves):
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g, x.grad, rtol=1e-5, atol=1e-5,
                                   msg=name)


def test_grad_output_of_any_strides():
    """The Function's backward takes a cotangent whose last axis is not
    contiguous, as autograd may hand it over."""
    q, k, v, _ = _inputs(1, 4, 2, 16, 16, 16, seed=3)
    co = np.random.default_rng(4).standard_normal((1, 16, 4, 16)).astype(
        np.float32)
    grads = []
    for cot in (torch.from_numpy(co),
                torch.from_numpy(np.ascontiguousarray(
                    co.transpose(0, 1, 3, 2))).transpose(2, 3)):
        leaves = [torch.from_numpy(x).transpose(1, 2).requires_grad_()
                  for x in (q, k, v)]
        flash_attention_bthd(*leaves, causal=True).backward(cot)
        grads.append([x.grad for x in leaves])
    assert grads[1][0].shape == grads[0][0].shape
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)


def test_backward_dispatches_on_device():
    """CPU tensors go to the plain version; a device with no kernel raises,
    and the CUDA-only kernel launchers refuse CPU tensors."""
    q = torch.zeros((1, 2, 8, 16))
    k = v = torch.zeros((1, 1, 8, 16))
    o, lse = fk.flash_attention_fwd(q, k, v, sc=0.25, causal=True)
    before = (fk.flash_attention_bwd_dq.launches,
              fk.flash_attention_bwd_dkv.launches)
    dq, dk, dv = fk.flash_attention_bwd(q, k, v, o, lse, q, sc=0.25,
                                        causal=True)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert (fk.flash_attention_bwd_dq.launches,
            fk.flash_attention_bwd_dkv.launches) == before
    # meta tensors (the dry run): empty meta gradients of the operands'
    # shapes, nothing launched; a device with no kernel raises
    meta = [x.to("meta") for x in (q, k, v, o, lse, q)]
    grads = fk.flash_attention_bwd(*meta, sc=0.25, causal=True)
    assert [(g.device.type, g.shape) for g in grads] == [
        ("meta", x.shape) for x in (q, k, v)]
    assert (fk.flash_attention_bwd_dq.launches,
            fk.flash_attention_bwd_dkv.launches) == before
    xpu = [types.SimpleNamespace(device=torch.device("xpu"))] * 6
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        fk.flash_attention_bwd(*xpu, sc=0.25, causal=True)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        fk.flash_attention_bwd_dq(q, k, v, q, lse, lse, sc=0.25, causal=True)
