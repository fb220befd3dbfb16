"""The numerical design of the tensor-core flash kernels, on the CPU.

The bf16 forward, dQ and dK/dV kernels run every product on the tensor
cores: q k^T and dO v^T from their bf16 operands (exact products, f32
sums), and each product with an f32 operand (p v, dS k, p^T dO, dS^T q) as
two bf16 products, of hi = bf16(x) and lo = bf16(x - hi), summed in f32.  The
port's plain mirror of that arithmetic (``flash_attention_split_plain``,
``flash_attention_bwd_split_plain``) goes against the JAX package's kernel
(``flash_attention`` in interpret mode, f32 throughout, and ``jax.grad``
through it) on the same seeded bf16 inputs, GQA 4:1, d 64 and 128, T a
multiple of the reference's 64-row chunk.

Each output is rounded to bf16, as the kernels write it, and held to the
card's checks (``chip_smoke.py``): every element within one bf16 rounding
(2^-8 of its magnitude) plus 1e-3 of the reference's rms; lse within 1e-4.
The control, hi alone (p and dS rounded to bf16 once), must exceed the
same limit, or the check could not tell the design from the fault it
guards against.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import (_fwd_call,  # noqa: E402
                                                  flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_split_plain, flash_attention_split_plain,
    split_bf16)

LIMIT = 1e-3        # chip_smoke.FLASH_O_ATOL and FLASH_BWD_ATOL
LSE_TOL = 1e-4      # chip_smoke.FLASH_LSE_TOL
CHUNK = 64          # the reference's cq = ck
# (B, H, KV, T = S, d, causal)
CASES = [
    (1, 8, 2, 128, 64, True),
    (1, 8, 2, 256, 128, True),
    (2, 8, 2, 128, 128, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, h, kv, t, d, seed):
    """q, k, v, dO as bf16 torch tensors and their f32 numpy values."""
    rng = np.random.default_rng(seed)
    out = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
           .to(torch.bfloat16) for shape in
           ((b, h, t, d), (b, kv, t, d), (b, kv, t, d), (b, h, t, d))]
    return out, [x.float().numpy() for x in out]


def _excess(got, want) -> float:
    """``chip_smoke.o_excess`` of ``got`` rounded to bf16, as the kernels
    write it, against the f32 reference ``want``."""
    got = got.to(torch.bfloat16).float()
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    err = (got - want).abs() - 2.0 ** -8 * want.abs()
    return float(err.max() / want.pow(2).mean().sqrt())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_forward_matches_reference_kernel(case):
    b, h, kv, t, d, causal = case
    (q, k, v, _), (qn, kn, vn, _) = _inputs(b, h, kv, t, d, seed=t + d)
    sc = d ** -0.5
    want_o, want_lse = _fwd_call(jnp.asarray(qn), jnp.asarray(kn),
                                 jnp.asarray(vn), sc=sc, causal=causal,
                                 cq=CHUNK, ck=CHUNK, interpret=True)
    o, lse = flash_attention_split_plain(q, k, v, sc=sc, causal=causal)
    assert _excess(o, want_o) <= LIMIT
    assert float(np.abs(lse.numpy() - np.asarray(want_lse)).max()) <= LSE_TOL
    control, _ = flash_attention_split_plain(q, k, v, sc=sc, causal=causal,
                                             lo=False)
    assert _excess(control, want_o) > LIMIT


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_backward_matches_reference_kernel(case):
    b, h, kv, t, d, causal = case
    (q, k, v, do), (qn, kn, vn, don) = _inputs(b, h, kv, t, d,
                                               seed=t + d + 1)
    sc = d ** -0.5

    def loss(q_, k_, v_):
        o_ = flash_attention(q_, k_, v_, sc, causal, CHUNK, CHUNK, True)
        return jnp.sum(o_ * don)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    o, lse = flash_attention_split_plain(q, k, v, sc=sc, causal=causal)
    got = flash_attention_bwd_split_plain(q, k, v, o, lse, do, sc=sc,
                                          causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _excess(g, w) <= LIMIT, name
    control = flash_attention_bwd_split_plain(q, k, v, o, lse, do, sc=sc,
                                              causal=causal, lo=False)
    for name, c, w in zip(("dq", "dk", "dv"), control, want):
        assert _excess(c, w) > LIMIT, name


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_split_keeps_sixteen_bits(scale):
    """hi is x rounded to bf16, lo the rest rounded to bf16: hi + lo is
    within 2^-16 of |x| (bf16 keeps 8 bits; the two halves about 16),
    where hi alone is off by up to 2^-9."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        scale / 8, scale, 4096).astype(np.float32))
    hi, lo = split_bf16(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    assert float(((hi + lo - x).abs() / x).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x).max()) > 2.0 ** -12
