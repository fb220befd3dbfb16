"""The port's flash-attention forward against the JAX package's.

The same numpy q, k, v go through the reference's ``flash_attention`` (its
Pallas forward in interpret mode, with lse from ``_fwd_call``) and the
port's kernel launcher on CPU tensors (the plain version), causal and full,
GQA 1:1 and 4:1, T = S = 32 and 64: O is held to rtol = atol = 2e-5 (the
reference test's own tolerance), lse to 1e-5.

At T = 200 the reference's chunk choice falls back to 128 and its kernel
never writes rows 128-199 (they hold NaN); the port computes every row, so
there it is held to ``attention_ref``, the reference's oracle, instead.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as ref_kernel  # noqa: E402
from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_bthd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

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


@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("h, kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference_kernel(t, h, kv, causal):
    d = 16
    q, k, v = _qkv(2, h, kv, t, d, seed=t + h + causal)
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


@pytest.mark.parametrize("causal", [True, False])
def test_model_layout_wrapper_matches_reference(causal):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 64, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    want = ref_ops.flash_attention_bthd(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        interpret=True)
    got = flash_attention_bthd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_attention_ref(causal):
    """T = 200: every row against the reference's oracle, where the JAX
    kernel leaves rows 128-199 unwritten."""
    rng = np.random.default_rng(200)
    q = rng.standard_normal((1, 200, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 200, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 200, 2, 16)).astype(np.float32)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    want = np.asarray(ref_attention(tr(q), tr(k), tr(v), causal=causal)
                      ).transpose(0, 2, 1, 3)
    got = flash_attention_bthd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **O_TOL)
    port_ref = attention_ref(torch.from_numpy(q).transpose(1, 2),
                             torch.from_numpy(k).transpose(1, 2),
                             torch.from_numpy(v).transpose(1, 2),
                             causal=causal).transpose(1, 2)
    np.testing.assert_allclose(port_ref.numpy(), want, **O_TOL)


def test_bf16_keeps_q_dtype_and_f32_lse():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 4, 2, 32, 16, seed=9))
    o, lse = fk.flash_attention_fwd(q, k, v, sc=0.25, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = attention_ref(q, k, v, causal=True, scale=0.25)
    torch.testing.assert_close(o, want, rtol=0, atol=1e-2)


def test_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 16, seed=1))
    before = fk.flash_attention_fwd.launches
    fk.flash_attention_fwd(q, k, v, sc=0.25, causal=False)
    assert fk.flash_attention_fwd.launches == before
    # meta tensors (the dry run): empty meta outputs of the kernel's
    # shapes, nothing launched; a device with no kernel raises
    o, lse = fk.flash_attention_fwd(q.to("meta"), k.to("meta"),
                                    v.to("meta"), sc=0.25, causal=False)
    assert o.device.type == lse.device.type == "meta"
    assert (o.shape, o.dtype) == (q.shape, q.dtype)
    assert (lse.shape, lse.dtype) == (q.shape[:3], torch.float32)
    assert fk.flash_attention_fwd.launches == before
    xpu = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        fk.flash_attention_fwd(xpu, xpu, xpu, sc=0.25, causal=False)
