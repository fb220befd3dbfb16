"""The port's ELL direct sparse conv and its non-kernel conv methods against
the JAX package.

The same numpy inputs go through the reference's ``sparse_conv`` (its Pallas
kernel in interpret mode, as the reference's own tests run it) and the
port's ``sparse_conv`` on CPU tensors (the kernel's plain version).  Both sum
each output in f32 nonzero by nonzero in the same order, so they agree to
rtol = atol = 1e-5.  ``csr-direct`` (``direct_sparse_conv``) and ``lowered``
(``lowered_sparse_conv``) are held to the reference's functions of the same
names at the same tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import direct_conv as ref_direct  # noqa: E402
from repro.core import lowering as ref_lowering  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.kernels.sparse_conv import ops as ref_ops  # noqa: E402
from repro_torch.core import direct_conv, lowering  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.sparse_conv import ops  # noqa: E402
from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (N, C, H, W, M, R, stride, pad, sparsity, relu, residual, balance)
CASES = [
    (2, 8, 12, 12, 16, 3, 1, 1, 0.7, True, False, False),
    (1, 16, 11, 11, 8, 1, 2, 0, 0.6, True, True, False),    # stride-2 1x1 tail
    (2, 4, 12, 12, 12, 3, 4, 2, 0.5, False, False, False),  # stride 4, pad 2
    (1, 6, 10, 9, 10, 5, 1, 2, 0.8, True, True, True),      # balanced bank
    (2, 12, 9, 9, 24, 3, 2, 1, 0.7, False, True, True),
    (1, 3, 12, 12, 8, 3, 1, 0, 0.0, True, False, False),    # dense weights
    (2, 16, 7, 7, 16, 3, 1, 1, 0.95, True, True, False),    # near-empty rows
]


def _inputs(case):
    n, c, h, w, m, r, stride, pad, sp, relu, with_res, balance = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    wt = magnitude_prune(rng.standard_normal((m, c, r, r)).astype(np.float32), sp)
    e, f = direct_conv.out_spatial(h, w, r, r, stride, pad)
    bias = rng.standard_normal(m).astype(np.float32)
    res = (rng.standard_normal((n, m, e, f)).astype(np.float32)
           if with_res else None)
    return x, wt, bias, res


@pytest.mark.parametrize("case", CASES)
def test_sparse_conv_matches_reference(case):
    n, c, h, w, m, r, stride, pad, sp, relu, with_res, balance = case
    x, wt, bias, res = _inputs(case)
    want = ref_ops.sparse_conv(
        jnp.asarray(x), ref_fmt.ell_from_dense_conv(wt, balance=balance),
        stride=stride, padding=pad, bias=jnp.asarray(bias), fuse_relu=relu,
        residual=None if res is None else jnp.asarray(res), interpret=True)
    launches = sparse_conv_kernel.launches
    got = ops.sparse_conv(
        torch.from_numpy(x),
        fmt.ell_from_dense_conv(wt, balance=balance, device="cpu"),
        stride=stride, padding=pad, bias=torch.from_numpy(bias),
        fuse_relu=relu, residual=None if res is None else torch.from_numpy(res))
    # a CPU tensor runs the plain version: the kernel's count does not move
    assert sparse_conv_kernel.launches == launches
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES[:4])
def test_direct_sparse_conv_matches_reference(case):
    n, c, h, w, m, r, stride, pad = case[:8]
    x, wt, _, _ = _inputs(case)
    want = ref_direct.direct_sparse_conv(
        jnp.asarray(x), ref_fmt.ell_from_dense_conv(wt), stride=stride,
        padding=pad)
    got = direct_conv.direct_sparse_conv(
        torch.from_numpy(x), fmt.ell_from_dense_conv(wt, device="cpu"),
        stride=stride, padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES[:4])
def test_lowered_sparse_conv_matches_reference(case):
    n, c, h, w, m, r, stride, pad = case[:8]
    x, wt, _, _ = _inputs(case)
    flat = wt.reshape(m, -1)
    want = ref_lowering.lowered_sparse_conv(
        jnp.asarray(x), ref_fmt.ell_from_dense(flat), r, r, stride=stride,
        padding=pad)
    got = lowering.lowered_sparse_conv(
        torch.from_numpy(x), fmt.ell_from_dense(flat, device="cpu"), r, r,
        stride=stride, padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        lowering.im2col(torch.from_numpy(x), r, r, stride=stride,
                        padding=pad).numpy(),
        np.asarray(ref_lowering.im2col(jnp.asarray(x), r, r, stride=stride,
                                       padding=pad)))


def test_dense_conv_matches_reference():
    x, wt, _, _ = _inputs(CASES[1])
    want = ref_direct.dense_conv(jnp.asarray(x), jnp.asarray(wt), stride=2)
    got = direct_conv.dense_conv(torch.from_numpy(x), torch.from_numpy(wt),
                                 stride=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pack_indices_and_epilogue_match_reference():
    _, wt, bias, _ = _inputs(CASES[3])
    ref_ell = ref_fmt.ell_from_dense_conv(wt)
    ell = fmt.ell_from_dense_conv(wt, device="cpu")
    np.testing.assert_array_equal(ops.pack_indices(ell).numpy(),
                                  np.asarray(ref_ops.pack_indices(ref_ell)))
    y = np.random.default_rng(0).standard_normal((2, 10, 3, 3)).astype(np.float32)
    res = np.random.default_rng(1).standard_normal((2, 10, 3, 3)).astype(np.float32)
    want = ref_ops.apply_epilogue(jnp.asarray(y), jnp.asarray(bias), True,
                                  jnp.asarray(res))
    got = ops.apply_epilogue(torch.from_numpy(y), torch.from_numpy(bias),
                             True, torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)


def test_resolve_schedule_covers_k_past_the_tpu_smem_budget():
    """res5 3x3 of ResNet-50 at 224 px (M=512, K=1504) falls back on the TPU
    (``smem_infeasible``); the card stages its channels in chunks and runs
    it, pipelined, within the block's shared memory."""
    ref_sched, reason = ref_ops.resolve_schedule(512, 512, 7, 7, 1504, 3, 3, 1)
    assert ref_sched is None and reason == "smem_infeasible"
    sched, reason = ops.resolve_schedule(512, 1504, 7, 7, n=8, c=512, r=3,
                                         s=3, hp=9, wp=9)
    assert reason is None and sched.pipeline
    assert sched.cc < 512   # K spans chunks
    assert budget.smem_fits(budget.ell_smem_bytes(
        sched.tm, sched.cc, 512, sched.rows, 9, 3, True))


@pytest.mark.parametrize("pinned, reason", [
    (dict(tm=3), "unsupported_tm"), (dict(tp=48), "unsupported_tp"),
    (dict(tp=512), "unsupported_tp")])
def test_resolve_schedule_rejects_what_the_kernel_does_not_take(pinned, reason):
    assert ops.resolve_schedule(64, 96, 14, 14, **pinned) == (None, reason)


def test_sparse_conv_raises_instead_of_falling_back():
    x, wt, _, _ = _inputs(CASES[0])
    with pytest.raises(ValueError, match="unsupported_tm"):
        ops.sparse_conv(torch.from_numpy(x),
                        fmt.ell_from_dense_conv(wt, device="cpu"), padding=1,
                        tm=3, layer="conv2")


def test_kernel_wrapper_raises_on_a_device_without_a_kernel():
    x, wt, bias, _ = _inputs(CASES[0])
    ell = fmt.ell_from_dense_conv(wt, device="meta")
    xpad = direct_conv.pad_in(torch.from_numpy(x), 1).to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sparse_conv_kernel(xpad, ell.value, ops.pack_indices(ell), ell.nnz,
                           torch.from_numpy(bias).to("meta"), rs=9, s=3,
                           e=12, f=12)
